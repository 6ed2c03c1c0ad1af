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

    @property
    def np_real(self) -> np.dtype:
        """The NumPy type of ``real``, for host arrays made in the run
        precision."""
        return np.dtype(np.float64 if self.real == torch.float64
                        else np.float32)


SINGLE = Precision(real=torch.float32, complex=torch.complex64)
DOUBLE = Precision(real=torch.float64, complex=torch.complex128)
_DEFAULT = SINGLE


def get_precision(precision=None) -> Precision:
    """Resolve a precision argument: None -> the default (SINGLE unless
    ``set_default_precision`` changed it), str -> named policy."""
    if precision is None:
        return _DEFAULT
    if isinstance(precision, Precision):
        return precision
    if isinstance(precision, str):
        if precision in ("single", "float32", "complex64"):
            return SINGLE
        if precision in ("double", "float64", "complex128"):
            return DOUBLE
        raise ValueError(f"Unknown precision {precision!r}")
    raise TypeError(f"Bad precision spec: {precision!r}")


def set_default_precision(precision) -> None:
    """Make ``precision`` what ``get_precision(None)`` resolves to, for
    the whole process (the JAX package's ``set_default_precision``)."""
    global _DEFAULT
    _DEFAULT = get_precision(precision)


def as_real(a, precision: Precision, device) -> torch.Tensor:
    """A tensor or array-like as a real tensor of ``precision`` on
    ``device`` (float64 host values are rounded once, to the target type)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=precision.real)
    return torch.as_tensor(np.asarray(a), device=device).to(precision.real)
