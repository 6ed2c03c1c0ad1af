"""Device mesh for the (frame, probe) parallel axes, on torch.distributed.

Counterpart of ``pyslice_tpu/parallel/mesh.py``. MD frames and probe
positions are independent until the time-FFT and probe-averaging
reductions, so they are the axes a run spreads over several cards. JAX's
single-controller ``Mesh`` becomes SPMD ranks: one process a rank,
launched by ``torchrun`` (``python -m torch.distributed.run``), and a
``torch.distributed.device_mesh.DeviceMesh`` with the dimension names
``("frame", "probe")`` whose per-axis process groups carry the
collectives of ``parallel.sharded``.

The backend is explicit. NCCL needs a card for each rank; a world of more
ranks than cards (several ranks sharing one card) must ask for Gloo, and
the CPU always runs Gloo. Nothing switches backend on its own.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

FRAME_AXIS = "frame"
PROBE_AXIS = "probe"


def factor_mesh(n_devices: int, n_frames: Optional[int] = None,
                n_probes: Optional[int] = None) -> Tuple[int, int]:
    """Pick (frame, probe) mesh extents for n_devices.

    Prefers sharding frames (the long axis in production TACAW runs); the
    probe extent only grows when the frame count can't absorb all devices or
    when probes are plentiful and frames are not.
    """
    best = (n_devices, 1)
    for f in range(n_devices, 0, -1):
        if n_devices % f:
            continue
        p = n_devices // f
        if n_frames is not None and n_frames % f:
            continue
        if n_probes is not None and n_probes % p:
            continue
        best = (f, p)
        break
    return best


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              dist.get_world_size() if dist.is_initialized()
                              else 1))


def pick_backend(device_type: str, backend: Optional[str],
                 local_ranks: int, n_cards: int) -> str:
    """The process-group backend for ``local_ranks`` ranks on one host with
    ``n_cards`` cards. CPU ranks run Gloo. CUDA ranks run NCCL when each
    has a card of its own; ranks that share cards need ``backend="gloo"``
    from the caller (NCCL refuses two ranks on one device)."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU ranks run the gloo backend, not {backend!r}")
        return "gloo"
    if backend is None:
        if local_ranks > n_cards:
            raise ValueError(
                f"{local_ranks} ranks share {n_cards} CUDA device(s): NCCL "
                "needs a card a rank; pass backend='gloo' to share cards")
        return "nccl"
    if backend == "nccl" and local_ranks > n_cards:
        raise ValueError(
            f"backend='nccl' with {local_ranks} ranks on {n_cards} CUDA "
            "device(s): NCCL needs a card a rank (use backend='gloo')")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    return backend


def initialize_multihost(**kwargs) -> None:
    """Join the job's process group: ``dist.init_process_group`` from the
    torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), once
    per process and before any mesh is built. Keyword arguments pass
    through (``backend``, ``timeout``, ...). Outside torchrun a process
    forms a world of one on a free localhost port. A process that is
    already in a group is left as it is."""
    if dist.is_initialized():
        return
    if "RANK" not in os.environ and "init_method" not in kwargs:
        kwargs.setdefault("init_method", f"tcp://localhost:{_free_port()}")
        kwargs.setdefault("rank", 0)
        kwargs.setdefault("world_size", 1)
    dist.init_process_group(**kwargs)


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _join(device, backend) -> str:
    """Join the process group for ranks on ``device`` (or check the one
    the process is in against ``backend``, when one is asked for); make
    the rank's card current. Returns the device type."""
    dtype = _device_type(device)
    n_cards = torch.cuda.device_count() if dtype == "cuda" else 0
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dtype == "cuda":
        # the rank's card, made current and initialized before the mesh:
        # DeviceMesh would otherwise pick cuda:LOCAL_RANK, which does not
        # exist where ranks share a card
        torch.cuda.set_device(local_rank % n_cards)
        torch.cuda.init()
    if dist.is_initialized():
        if backend is not None:
            want = pick_backend(dtype, backend, _local_world_size(), n_cards)
            have = dist.get_backend()
            if want not in str(have).split(","):
                raise ValueError(f"the process group runs {have!r}, "
                                 f"not the requested {want!r}")
        return dtype
    want = pick_backend(dtype, backend,
                        int(os.environ.get("LOCAL_WORLD_SIZE", 1)), n_cards)
    if want == "nccl":
        initialize_multihost(backend=want, device_id=torch.device(
            "cuda", local_rank % n_cards))
    else:
        initialize_multihost(backend=want)
    return dtype


def _extents(n: int, n_frame_shards, n_probe_shards) -> Tuple[int, int]:
    """JAX's extent rules over ``n`` ranks."""
    if n_frame_shards is None and n_probe_shards is None:
        n_frame_shards, n_probe_shards = factor_mesh(n)
    elif n_frame_shards is None:
        n_frame_shards = n // n_probe_shards
    elif n_probe_shards is None:
        n_probe_shards = n // n_frame_shards
    if n_frame_shards * n_probe_shards != n:
        raise ValueError(
            f"mesh {n_frame_shards}x{n_probe_shards} != {n} devices")
    return n_frame_shards, n_probe_shards


def make_mesh(n_frame_shards: Optional[int] = None,
              n_probe_shards: Optional[int] = None,
              backend: Optional[str] = None, device=None):
    """DeviceMesh with dimensions ('frame', 'probe') over every rank of the
    job, ranks laid out row-major (rank = frame * n_probe + probe).

    Joins the process group first if the process is not in one
    (``initialize_multihost``). ``device``: "cpu" for CPU ranks on Gloo;
    otherwise the card (a rank's card is ``cuda:(LOCAL_RANK %
    device_count)``, made current). ``backend``: see ``pick_backend``;
    in a process group already, None keeps its backend and another one
    raises."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _join(device, backend)
    f, p = _extents(dist.get_world_size(), n_frame_shards, n_probe_shards)
    return init_device_mesh(dtype, (f, p),
                            mesh_dim_names=(FRAME_AXIS, PROBE_AXIS))


def multihost_layout(world_size: int, local_world_size: int,
                     n_probe_shards: int = 1) -> np.ndarray:
    """(n_frame, n_probe) rank grid of a multi-node job: the probe axis
    inside a node, the frame axis across nodes (torchrun numbers a node's
    ranks contiguously, node * local_world_size + local_rank)."""
    if local_world_size < 1 or world_size % local_world_size:
        raise ValueError(f"world size {world_size} is not a whole number of "
                         f"nodes of {local_world_size} ranks")
    if local_world_size % n_probe_shards:
        raise ValueError(
            f"probe shards ({n_probe_shards}) must divide the per-host "
            f"device count ({local_world_size}) so the probe axis stays on "
            "one host")
    return np.arange(world_size).reshape(-1, n_probe_shards)


def make_multihost_mesh(n_probe_shards: int = 1,
                        local_world_size: Optional[int] = None,
                        backend: Optional[str] = None, device=None):
    """('frame', 'probe') mesh for a multi-node job: frames, the axis that
    exchanges nothing while it propagates, cross the nodes; probe shards
    stay inside a node. ``local_world_size`` defaults to torchrun's
    LOCAL_WORLD_SIZE. One process degrades to ``make_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    dtype = _join(device, backend)
    world = dist.get_world_size()
    n_local = (int(local_world_size) if local_world_size is not None
               else _local_world_size())
    layout = multihost_layout(world, n_local, n_probe_shards)
    if world == 1:
        return make_mesh(None, n_probe_shards, backend, device)
    return DeviceMesh(dtype, torch.as_tensor(layout),
                      mesh_dim_names=(FRAME_AXIS, PROBE_AXIS))


def world_group(mesh):
    """The process group of every rank of ``mesh``: the default group,
    which a mesh from ``make_mesh`` spans (the group that JAX's reductions
    over all mesh axes use)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks must span the "
                         f"job's {dist.get_world_size()}")
    return dist.group.WORLD


def extent(mesh, axis: str) -> int:
    """The mesh's extent along ``axis``."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def coord(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def flat_index(mesh) -> int:
    """This rank's position in the mesh flattened row-major (frame, probe):
    the order in which JAX shards an axis over every mesh device."""
    return coord(mesh, FRAME_AXIS) * extent(mesh, PROBE_AXIS) \
        + coord(mesh, PROBE_AXIS)
