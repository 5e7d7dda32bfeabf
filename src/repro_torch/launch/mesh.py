"""Mesh constructors (port of ``repro/launch/mesh.py``).

Both are functions that read the started ``torch.distributed`` group, so
importing this module touches no device and no process group. The rank
processes start the group first (``distributed.context.init_process_group``
from a ``file://`` store, or ``launch/train.py`` from ``torchrun``'s
environment); a group of another size than the mesh raises ``ValueError``
naming the ranks it needs, which the launcher turns into its exit.
"""
from __future__ import annotations

from repro_torch.distributed.context import Mesh, make_mesh


def _world_size() -> int:
    import torch.distributed as tdist
    if not tdist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start "
                           "the process group first "
                           "(distributed.context.init_process_group)")
    return tdist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production grid: (data 16, model 16) on 256 ranks, or (pod 2,
    data 16, model 16) on 512 with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    n = _world_size()
    if n != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} ranks, the group has {n}")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """Whatever ranks the group has, as a (data, model) grid: a model
    axis of 2 (1 for a single rank), the rest data."""
    n = _world_size()
    shape = (max(n // 2, 1), 2 if n >= 2 else 1)
    return make_mesh(shape, ("data", "model"))
