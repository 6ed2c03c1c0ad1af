"""Hand-written CUDA kernels for the slice step, and their dispatch flags.

``config.fused_multislice``, the counterpart of the JAX flag of the same
name: "auto" (default — use the fused CUDA kernels for an eligible problem
on the card), "on" (require them; error if the problem is not eligible),
or "off" (always the plain ``torch.fft`` path, for A/B checks).
``config.resident_multislice``: "auto" (default — the one-launch slice
loop K6 where ``physics.propagate.fused_family`` prefers it) or "off"
(always the two-pass chains). Both are read at every call.

Kernel map (``pyslice_tpu/ops`` Pallas kernel -> this package):

* ``fused_step._kernel_a`` / ``_kernel_b`` / ``_kernel_c`` ->
  ``fused_step.row_pass`` / ``col_pass`` / ``kconvert``, CUDA C++ in
  ``csrc/fused_step.cu`` (power-of-two axes; A and B on the
  register-resident engine ``csrc/fft_regs.cuh``, C on the radix-16
  engine ``csrc/fft_pow2.cuh``).
* ``transmit._kernel`` (psi * exp(i sigma V), cos/sin in the kernel) is
  kernel A's ``only`` mode with the phase plane:
  ``row_pass("only", psi, sigma * V)``. It has no kernel of its own.
* ``fused_step_odd._kernel_a`` / ``_kernel_b`` -> K4 / K5,
  ``fused_step_odd.row_pass_mr`` / ``col_pass_mr``, in
  ``csrc/fused_step_odd.cu`` (mixed-radix Stockham engine,
  ``csrc/fft_mixed.cuh``; persistent blocks with producer warps,
  ``csrc/tile_async.cuh``). Dispatch gives them, K6 and K8 only axes whose
  stages all run in registers (``fused_step_odd.kernel_preferred_mr``).
* ``fused_step_resident._kernel_resident`` (#5) and
  ``fused_step_odd_resident._kernel`` (#8) -> K6,
  ``fused_step_resident.resident_loop`` in ``csrc/resident.cu``, one
  cooperative launch a frame in two instantiations: A's and B's register
  engine on power-of-two grids (#5), K4's and K5's persistent tiles
  otherwise (#8); ``fused_step_resident.resident_plan`` sizes it. Entry
  points:
  ``fused_step_resident.fused_multislice[_kspace]_resident`` and
  ``fused_step_odd_resident.fused_multislice[_kspace]_odd_resident``.
* ``fused_step_adjoint._kernel_a_bwd`` (#9) and ``_kernel_a_bwd_odd``
  (#10) -> K7 ``fused_step_adjoint.row_pass_bwd`` (``csrc/
  fused_step_adjoint.cu``, A's register-resident engine) and K8
  ``row_pass_mr_bwd`` (``csrc/fused_step_adjoint_odd.cu``, K4's
  persistent tiles on the Stockham engine). Chains
  ``fused_step_adjoint.fused_adjoint_chain[_odd]`` reuse A / K4
  (``first``) and B / K5 with conj(t) and conj(P); entry point
  ``physics.adjoint.multislice_diff``.

One kernel has no Pallas counterpart: ``csrc/time_fft.cu``, the TACAW
time FFT (mean, length-T transform, |.|^2 and the shifted store in one
pass), which the JAX package leaves to XLA. It is built here with the
others; its wrapper ``analysis.time_fft`` sits beside its caller
``analysis.tacaw``, which routes a block to it by its frame count
(``analysis.time_fft.kernel_takes``).
"""


class config:
    fused_multislice = "auto"
    resident_multislice = "auto"
