"""Hand-written CUDA kernels for the slice step, and their dispatch flag.

``config.fused_multislice``, the counterpart of the JAX flag of the same
name: "auto" (default — use the fused CUDA kernels for an eligible problem
on the card), "on" (require them; error if the problem is not eligible),
or "off" (always the plain ``torch.fft`` path, for A/B checks). It is read
at every call.

Kernel map (``pyslice_tpu/ops`` Pallas kernel -> this package):

* ``fused_step._kernel_a`` / ``_kernel_b`` / ``_kernel_c`` ->
  ``fused_step.row_pass`` / ``col_pass`` / ``kconvert``, CUDA C++ in
  ``csrc/fused_step.cu``.
* ``transmit._kernel`` (psi * exp(i sigma V), cos/sin in the kernel) is
  kernel A's ``only`` mode with the phase plane:
  ``row_pass("only", psi, sigma * V)``. It has no kernel of its own.
"""


class config:
    fused_multislice = "auto"
