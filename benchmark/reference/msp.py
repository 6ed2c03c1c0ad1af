"""One Adam step of multislice electron ptychography, in plain PyTorch.

The step that ``msp_reconstruct`` takes, written again from the method's
description (Chen et al., Science 372, 826 (2021): a mixed-state probe
through the multislice, the detector amplitudes fitted by gradient
descent) and from optax's Adam. It imports nothing of the program: the
state before the step (the potential, the probe modes, the scan
positions, the Adam moments, the minibatch's detector intensities, all
as tensors) is handed over, and the amplitudes, the grid, the shift
ramps, the multislice, the misfit, the gradients (plain autograd) and the
update are worked out again.

* shift: mode j at position p is ``ifft2(fft2(mode_j) exp(+2 pi i k.p))``;
* multislice: ``psi <- ifft2(P fft2(t_s psi))`` for all but the last
  slice, then ``t_last psi``; ``t = exp(i sigma V)``, ``P = exp(-i pi
  lambda dz k^2)``, ``dz = lz / nz``;
* misfit: the mean over the minibatch's patterns and pixels of
  ``(sqrt(sum_j |fft2(exit_j)|^2 + 1e-24) - a)^2``, the modes summed on
  the detector;
* Adam (optax's defaults): ``mu <- 0.1 g + 0.9 mu``, ``nu <- 0.001 |g|^2 +
  0.999 nu``, the update ``-lr mu_hat / (sqrt(nu_hat) + 1e-8)``, with
  PyTorch's gradient of a complex parameter (the conjugate of JAX's).

``TRUTH`` computes in float64 / complex128. ``CONTROL`` computes in
complex64 and rounds the input of every two-dimensional transform to TF32
(10 mantissa bits), forward and backward, as an FFT done as tensor-core
products would. The minibatch is taken in blocks of patterns, each
block's share of the loss backpropagated before the next, so that the
autograd graph of one block is held at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import plain

B1, B2, EPS = 0.9, 0.999, 1e-8


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """A complex64 tensor with its real and imaginary parts rounded to
    TF32."""
    return torch.view_as_complex(plain._tf32(torch.view_as_real(x)))


class _RoundIn(torch.autograd.Function):
    """Rounds its input to TF32; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBack(torch.autograd.Function):
    """Passes its input unchanged; rounds the gradient to TF32 (the input
    of the transform's adjoint)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _transforms(prec):
    """(fft2, ifft2) of the precision: TF32-rounded inputs under
    ``tf32_products``."""
    if not prec.tf32_products:
        return torch.fft.fft2, torch.fft.ifft2

    def wrap(f):
        return lambda x: _RoundBack.apply(f(_RoundIn.apply(x)))
    return wrap(torch.fft.fft2), wrap(torch.fft.ifft2)


def _adam(grad, moments, lr):
    """The change Adam makes to a parameter with gradient ``grad``, from
    the moments before the step ((mu, nu, count); mu None before the
    first step)."""
    mu, nu, count = moments
    mu = torch.zeros_like(grad) if mu is None else mu.to(grad.dtype)
    nu = torch.zeros_like(grad.real) if nu is None else nu.to(
        grad.real.dtype)
    count += 1
    g2 = (grad.conj() * grad).real if grad.is_complex() else grad ** 2
    mu = (1 - B1) * grad + B1 * mu
    nu = (1 - B2) * g2 + B2 * nu
    mu_hat = mu / (1 - B1 ** count)
    nu_hat = nu / (1 - B2 ** count)
    return (-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))


def gradients(state: dict, grid: plain.Grid, eV: float, prec, device,
              block: int) -> tuple:
    """(the minibatch's loss, {name: gradient}) at the state before the
    step, for the parameters refined.

    ``state``: ``v`` (nz, nx, ny), ``modes`` (K, nx, ny), ``pos`` (npos,
    2) Angstrom, ``idx`` (nb,) the minibatch, ``inten`` (nb, nx, ny) its
    detector intensities as the data holds them (the zero frequency at
    the centre), ``moments`` {name: (mu, nu, count)} of the parameters
    refined (``v`` always; ``modes``, ``pos`` where the solve refines
    them). The amplitudes fitted are the square roots of the intensities
    (a negative count read as 0), put back in the transform's order.
    """
    real, cplx = prec.real, prec.complex
    fft2, ifft2 = _transforms(prec)
    on = lambda t, dt: torch.as_tensor(t).detach().to(
        device=device, dtype=dt, copy=True)
    kx = on(grid.kx(), torch.float64).to(real)
    ky = on(grid.ky(), torch.float64).to(real)
    lam, sig = plain.wavelength(eV), plain.sigma(eV)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    chi = (-math.pi * lam * grid.dz) * k2
    prop = torch.polar(torch.ones_like(chi), chi)

    names = list(state["moments"])
    params = {"v": on(state["v"], real), "modes": on(state["modes"], cplx),
              "pos": on(state["pos"], real)}
    for name in names:
        params[name].requires_grad_()
    v, modes, pos = params["v"], params["modes"], params["pos"]
    idx = torch.as_tensor(np.asarray(state["idx"]), device=device).long()
    inten0 = torch.fft.ifftshift(on(state["inten"], real), dim=(-2, -1))
    amps = torch.sqrt(torch.clamp(inten0, min=0.0))
    nb, n_pix = len(idx), amps.shape[-1] * amps.shape[-2]

    loss = 0.0
    for b0 in range(0, nb, block):
        sel = slice(b0, b0 + block)
        p = pos[idx[sel]]
        ph = (2.0 * math.pi) * (kx[None, :, None] * p[:, 0, None, None]
                                + ky[None, None, :] * p[:, 1, None, None])
        ramp = torch.polar(torch.ones_like(ph), ph)
        psi = ifft2(fft2(modes)[None] * ramp[:, None])
        t = torch.polar(torch.ones_like(v), torch.tensor(
            sig, dtype=real, device=device) * v)
        for s in range(v.shape[0] - 1):
            psi = ifft2(prop * fft2(t[s] * psi))
        inten = (fft2(t[-1] * psi).abs() ** 2).sum(dim=1)
        part = ((torch.sqrt(inten + 1e-24) - amps[sel]) ** 2).sum() / (
            nb * n_pix)
        part.backward()
        loss += float(part.detach())
        del psi, inten, part
    return loss, {name: params[name].grad for name in names}


def step(state: dict, grid: plain.Grid, eV: float, lrs: dict, prec,
         device, block: int) -> dict:
    """The minibatch's loss before the step (``loss``, a float), each
    refined parameter's gradient (``grad_<name>``) and change
    (``update_<name>``), host arrays in float64 or complex128, from
    ``state`` (as ``gradients`` takes it) and ``lrs`` ({name: learning
    rate})."""
    loss, grads = gradients(state, grid, eV, prec, device, block)
    out = {"loss": loss}
    with torch.no_grad():
        for name, g in grads.items():
            delta = _adam(g, state["moments"][name], lrs[name])
            out["update_" + name] = _host(delta)
            out["grad_" + name] = _host(g)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.complex128 if t.is_complex()
                else torch.float64).cpu().numpy()
