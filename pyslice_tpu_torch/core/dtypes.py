"""Precision policy for the PyTorch port.

Two modes, as in ``pyslice_tpu/core/dtypes.py``:

* ``single`` — float32 / complex64, the default and the only precision the
  hand-written CUDA kernels take.
* ``double`` — float64 / complex128, the verification mode for CPU checks
  against the JAX package in x64 mode.

TF32 is switched off here, once, when the package is imported: a float32
matrix product (the rasterizer's structure-factor matmul) then runs in full
float32 on the card, as the 1e-6 magnitude-residual bar needs. TF32 keeps
about three decimal digits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Precision:
    real: torch.dtype
    complex: torch.dtype

    @property
    def name(self) -> str:
        return "double" if self.real == torch.float64 else "single"


SINGLE = Precision(real=torch.float32, complex=torch.complex64)
DOUBLE = Precision(real=torch.float64, complex=torch.complex128)


def get_precision(precision=None) -> Precision:
    """Resolve a precision argument: None -> SINGLE, str -> named policy."""
    if precision is None:
        return SINGLE
    if isinstance(precision, Precision):
        return precision
    if isinstance(precision, str):
        if precision in ("single", "float32", "complex64"):
            return SINGLE
        if precision in ("double", "float64", "complex128"):
            return DOUBLE
        raise ValueError(f"Unknown precision {precision!r}")
    raise TypeError(f"Bad precision spec: {precision!r}")


def as_real(a, precision: Precision, device) -> torch.Tensor:
    """A tensor or array-like as a real tensor of ``precision`` on
    ``device`` (float64 host values are rounded once, to the target type)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=precision.real)
    return torch.as_tensor(np.asarray(a), device=device).to(precision.real)
