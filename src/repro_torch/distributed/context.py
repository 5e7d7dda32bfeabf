"""DistContext: the one object threaded through the model's serving
forwards that knows the mesh, this rank's place in it and the axis
conventions (port of ``repro/distributed/context.py``). ``None`` in its
place is a single device.

The reference shards with GSPMD: its params carry ``NamedSharding``s and
``constrain_seq`` / ``constrain_logits`` are layout hints that XLA turns
into collectives. The port is Megatron-style instead: every rank holds
plain local tensors (its shard of each leaf, ``distributed/sharding.py``),
the hand-written kernels see those local tensors, and the model calls
the collectives itself over the ``model`` axis:

  * ``all_reduce`` (sum) after a row-parallel product (attention's
    ``wo``, the MLP's down projection, the masked embedding lookup);
  * ``all_gather`` (concatenated along a dim, in rank order) where a
    column-parallel output must be whole (the packed GLU's output before
    ``bspmm``, vocab-sharded logits before a draw);
  * ``vocab_argmax``: the greedy token over vocab-sharded logits, one
    small all-gather of each rank's best (value, index, finite) per row.

What the two hints meant becomes: the residual stream stays replicated
over the model axis (``sp``, sequence parallelism, is not ported: the
field is kept and must stay False), and the logits are vocab-sharded
wherever the vocabulary divides the model axis.

``Mesh`` is the port's stand-in for ``jax.sharding.Mesh``: axis names,
shape, this rank's coordinates and one process group per axis of size
> 1. ``init_process_group`` starts ``torch.distributed`` from a
``file://`` store in a directory (no TCP port to collide on), and
``make_mesh`` builds the groups; ``launch/mesh.py`` picks the shape.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device grid as ``torch.distributed`` sees it from one rank."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    # axis name -> process group over the ranks that differ only in that
    # axis (absent for an axis of size 1)
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on every axis (row-major: the last axis
        varies fastest, so the model axis of a (data, model) grid holds
        consecutive ranks)."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)


def _axis_lines(shape: tuple[int, ...], axis: int) -> list[list[int]]:
    """Every line of ranks along ``axis`` of a row-major grid, in order."""
    lines = []
    for idx in itertools.product(*[range(n) for n in shape]):
        if idx[axis] == 0:
            lines.append([_flat(idx[:axis] + (c,) + idx[axis + 1:], shape)
                          for c in range(shape[axis])])
    return lines


def _flat(idx: tuple[int, ...], shape: tuple[int, ...]) -> int:
    r = 0
    for i, n in zip(idx, shape):
        r = r * n + i
    return r


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """The mesh of the started process group (``torch.distributed`` must
    be initialised with a world size of ``prod(shape)``). Every rank
    calls this with the same arguments: group creation is collective."""
    import torch.distributed as tdist
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
    world = tdist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    rank = tdist.get_rank()
    groups = {}
    for i, name in enumerate(axis_names):
        if shape[i] == 1:
            continue
        for line in _axis_lines(shape, i):
            g = (tdist.group.WORLD if len(line) == world
                 else tdist.new_group(line))
            if rank in line:
                groups[name] = g
    return Mesh(axis_names, shape, rank, groups)


def init_process_group(directory: str, rank: int, world_size: int,
                       backend: str = "gloo") -> None:
    """Start ``torch.distributed`` for ``rank`` of ``world_size`` from a
    ``file://`` store in ``directory`` (every rank names the same one; it
    must not hold a store of an earlier group)."""
    import torch.distributed as tdist
    store = os.path.join(os.path.abspath(directory), "store")
    tdist.init_process_group(backend, init_method=f"file://{store}",
                             rank=rank, world_size=world_size)


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Mesh | None = None
    model_axis: str = "model"
    # sequence-parallel residual stream: not ported (the residual stays
    # replicated over the model axis)
    sp: bool = False

    def __post_init__(self):
        if self.sp:
            raise NotImplementedError(
                "sequence-parallel residual (sp=True) is not ported "
                "(ROADMAP §1 item 4)")

    # --------------------------------------------------------- the mesh
    @property
    def batch_axes(self) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        return tuple(a for a in ("pod", "data")
                     if a in self.mesh.axis_names)

    def batch_pspec(self, ndim: int) -> tuple:
        ax = self.batch_axes
        first = ax if len(ax) > 1 else (ax[0] if ax else None)
        return (first,) + (None,) * (ndim - 1)

    @property
    def tp(self) -> int:
        """Size of the model axis."""
        return 1 if self.mesh is None else self.mesh.axis_size(
            self.model_axis)

    @property
    def data_size(self) -> int:
        """Product of the batch axes' sizes."""
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.axis_size(a) for a in self.batch_axes)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis."""
        if self.mesh is None or self.model_axis not in self.mesh.axis_names:
            return 0
        return self.mesh.coords[self.model_axis]

    def shards(self, dim: int) -> bool:
        """Whether a dim under a model-axis rule is split (the rule drops
        where the model axis does not divide it, ``sharding.spec_for``)."""
        return self.tp > 1 and dim % self.tp == 0

    # ---------------------------------------------------- collectives
    def _group(self):
        return self.mesh.groups[self.model_axis]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model axis, in place; returns it."""
        if self.tp == 1:
            return x
        import torch.distributed as tdist
        x = x.contiguous()
        tdist.all_reduce(x, group=self._group())
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every model-axis rank's ``x`` along ``dim``, in
        rank order."""
        if self.tp == 1:
            return x
        import torch.distributed as tdist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        tdist.all_gather(parts, x, group=self._group())
        return torch.cat(parts, dim=dim)

    def vocab_argmax(self, logits: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(argmax over the whole vocabulary (B,) int64, all logits
        finite (B,) bool) of vocab-sharded rows (B, V / tp): each rank's
        best value and its global index, and its finite check, in one
        all-gather. Ties go to the lowest index, as ``torch.argmax`` on
        the whole row breaks them: the lowest rank among equal bests,
        each rank's own first maximum."""
        local = torch.argmax(logits, dim=-1)
        best = torch.gather(logits, -1, local[:, None])[:, 0].double()
        gidx = (local + self.model_rank * logits.shape[-1]).double()
        fin = torch.isfinite(logits).all(dim=-1).double()
        g = self.all_gather(torch.stack([best, gidx, fin])[None], dim=0)
        pick = torch.argmax(g[:, 0], dim=0)                 # (B,)
        idx = torch.gather(g[:, 1], 0, pick[None])[0].to(torch.int64)
        return idx, g[:, 2].min(dim=0).values > 0


def check_serving(cfg, dist) -> None:
    """Refuse a multi-device context where this slice does not serve:
    tensor-parallel serving covers the dense GLU family on a mesh whose
    batch axes have size 1."""
    if dist is None:
        return
    if cfg.family != "dense" or cfg.mlp_kind != "glu" or cfg.is_moe:
        raise NotImplementedError(
            f"dist= serves the dense GLU family only, not {cfg.family!r} "
            f"with mlp_kind {cfg.mlp_kind!r} (ROADMAP §1 item 4: dist= on "
            "the other families)")
    if dist.data_size > 1:
        raise NotImplementedError(
            "a serving data axis larger than 1 is not ported (ROADMAP §1 "
            "item 4: sequence-parallel and a serving data axis)")
