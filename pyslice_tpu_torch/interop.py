"""Carry state from the JAX package to the port as NumPy data.

The tests feed both packages the same rasterization plan and probe batch:
the JAX ``RasterizerPlan``'s fields (all NumPy arrays or Python scalars)
and the JAX probe array, converted to NumPy by the caller. Nothing here
imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.dtypes import get_precision
from .physics.potential import RasterizerPlan


def plan_from_numpy(fields: dict) -> RasterizerPlan:
    """The port's RasterizerPlan from a dict of the JAX plan's fields (for
    example ``{f.name: getattr(plan, f.name) for f in
    dataclasses.fields(plan)}``). Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(RasterizerPlan)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown RasterizerPlan fields: {sorted(extra)}")
    vals = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()}
    return RasterizerPlan(**vals)


def spec_with_plan(spec, fields: dict):
    """A copy of a port ``SimSpec`` whose plan is ``plan_from_numpy``'s."""
    return dataclasses.replace(spec, plan=plan_from_numpy(fields))


def probes_from_numpy(arr, device, precision=None) -> torch.Tensor:
    """A (n_probes, nx, ny) probe batch from a NumPy array, as a complex
    tensor of ``precision`` on ``device``."""
    prec = get_precision(precision)
    return torch.as_tensor(np.array(arr), device=device).to(prec.complex)
