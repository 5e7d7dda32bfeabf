"""DistContext: the one object threaded through the model's forwards
(serving and training) that knows the mesh, this rank's place in it and
the axis conventions (port of ``repro/distributed/context.py``). ``None``
in its place is a single device.

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
  * ``reduce_scatter`` (the sum, of which each rank keeps its slice of a
    dim) after a row-parallel product under ``sp``;
  * ``vocab_argmax``: the greedy token over vocab-sharded logits, one
    small all-gather of each rank's best (value, index, finite) per row.

What the two hints mean in the port: the logits are vocab-sharded
wherever the vocabulary divides the model axis, and ``sp`` (sequence
parallelism, Megatron-SP; on by default, as in the reference) splits the
residual stream's sequence dim over the model axis where
``constrain_seq`` would (``seq_split``: a 3-D activation, a model axis
of size > 1 and S divisible by it; otherwise the residual stays
replicated, as the reference leaves it). Only the full-sequence forward
(``models/transformer.py::forward``: training and the full-sequence
prefill) takes it; the cache steps of serving keep the replicated
stream, as in the reference, where ``constrain_seq`` appears only in
``forward``.

Training differentiates through the collectives, so it uses Megatron's
conjugate pairs, each a ``torch.autograd.Function`` (outside autograd they
are the serving collectives above):

  * ``reduce_from_model``: forward sums over the model axis, backward
    passes the gradient through (after a row-parallel product; not
    ``torch.distributed.nn``'s all_reduce, whose backward sums again and
    so gives tp times the gradient of a replicated residual stream);
  * ``copy_to_model``: forward is the identity, backward sums the
    gradient over the model axis (before a column-parallel product, and
    on a replicated leaf that each rank uses only in part: the kv heads
    that ``attention.shard_local`` narrows);
  * ``gather_from_model``: forward all-gathers, backward keeps this
    rank's slice;
  * under ``sp``, on the sequence dim (1) of a (B, S, D) activation:
    ``gather_from_seq`` all-gathers the S shards in the forward and
    reduce-scatters the gradient in the backward (before a
    column-parallel product); ``reduce_scatter_to_seq`` reduce-scatters
    the partial sums in the forward and all-gathers the gradient in the
    backward (after a row-parallel one); ``scatter_to_seq`` keeps this
    rank's S slice in the forward and all-gathers the gradient in the
    backward (after an op every rank computes whole). ``to_parallel`` and
    ``from_parallel`` pick the pair for a product from whether it is
    split and whether the stream is;
  * ``copy_to_model(reduce_from_model(x))`` sums over the model axis
    both ways (a value every rank needs whole, made of each rank's
    partial share, then used by each rank on its own shard: zamba's
    gated RMSNorm over all of ``d_inner``);
  * ``sum_over_data`` / ``mean_over_data``: a gradient summed or averaged
    over the batch axes, in place, after the backward. Under ``sp`` the
    replicated leaves that act on an S shard (``sharding.seq_partial_flags``:
    the norms' scales and biases) hold partial gradients, which
    ``sum_over_model`` adds up after the backward.

A serving data axis (the batch axes ``pod`` and ``data`` larger than 1):
every rank is handed the global batch and computes its own rows,
``batch_rows``, on ``model_only()``, a context that sees the model axis
alone (so the model's collectives never cross a data group), and
``gather_rows`` puts the rows back together over the batch axes, so
every rank returns the whole batch as the reference's global arrays
are. A batch the batch axes do not divide is computed whole by every
data group (the reference drops such an axis, ``sharding.batch_sharding``).

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

def _wire(x: torch.Tensor) -> torch.Tensor:
    """gloo moves no bool tensors: their bytes as uint8."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


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


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              ranks: list[int] | None = None) -> Mesh | None:
    """The mesh of the started process group (``torch.distributed`` must
    be initialised with a world size of ``prod(shape)``). Every rank
    calls this with the same arguments: group creation is collective.

    ``ranks`` (world ranks, ``prod(shape)`` of them, in mesh order) builds
    the mesh over part of the group instead: every rank of the world still
    calls it, and the ranks outside get ``None`` (a restart onto a
    smaller mesh inside one group)."""
    import torch.distributed as tdist
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
    world = tdist.get_world_size()
    members = list(range(world)) if ranks is None else list(ranks)
    if math.prod(shape) != len(members):
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks, the group has "
                         f"{len(members)}")
    me = tdist.get_rank()
    groups = {}
    for i, name in enumerate(axis_names):
        if shape[i] == 1:
            continue
        for line in _axis_lines(shape, i):
            line = [members[j] for j in line]
            g = (tdist.group.WORLD if len(line) == world
                 else tdist.new_group(line))
            if me in line:
                groups[name] = g
    if me not in members:
        return None
    return Mesh(axis_names, shape, members.index(me), groups)


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
    sp: bool = True          # sequence-parallel residual stream

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

    def seq_split(self, x) -> bool:
        """Whether the residual stream ``x`` (a tensor or its shape) is
        split along S under ``sp``: the conditions of the reference's
        ``constrain_seq``, a 3-D activation, a model axis of size > 1 and
        S divisible by it."""
        shape = tuple(x.shape) if torch.is_tensor(x) else tuple(x)
        return (self.sp and len(shape) == 3 and self.tp > 1
                and shape[1] % self.tp == 0)

    def expert_range(self, num_experts: int) -> tuple[int, int]:
        """(offset, count) of the experts this rank holds and computes
        under expert parallelism: ``[model_rank * E/tp, (model_rank + 1)
        * E/tp)``, the reference's ``axis_index * e_l``."""
        n = num_experts // self.tp
        return self.model_rank * n, n

    @property
    def data_rank(self) -> int:
        """This rank's index over the batch axes (the first major)."""
        if self.mesh is None:
            return 0
        c, r = self.mesh.coords, 0
        for a in self.batch_axes:
            r = r * self.mesh.axis_size(a) + c[a]
        return r

    def batch_rows(self, batch: int) -> tuple[int, int]:
        """(first row, rows) of a global batch that this data group
        computes: ``[r * B/dp, (r + 1) * B/dp)`` for data rank r of dp,
        the whole batch where dp does not divide it."""
        dp = self.data_size
        if dp == 1 or batch % dp:
            return 0, batch
        n = batch // dp
        return self.data_rank * n, n

    def model_only(self) -> "DistContext":
        """This rank's view of its model axis alone (the batch axes
        dropped): the context a data group runs its rows on."""
        if self.mesh is None or self.data_size == 1:
            return self
        m = self.mesh
        g = {a: v for a, v in m.groups.items() if a == self.model_axis}
        return dataclasses.replace(self, mesh=Mesh(
            (self.model_axis,), (self.tp,), self.model_rank, g))

    def gather_rows(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """The global batch's rows (dim 0) from every data group's
        ``batch_rows`` share, in data-rank order (collective over the
        batch axes); ``x`` itself where every group computed the whole
        ``batch``."""
        if self.batch_rows(batch)[1] == batch:
            return x
        return torch.cat(self.gather_over_data(x), dim=0)

    def gather_objects(self, obj) -> list:
        """Every data rank's picklable ``obj``, in data-rank order
        (collective over the batch axes, one at a time)."""
        import torch.distributed as tdist
        parts = [obj]
        for a in reversed(self.batch_axes):
            n = self.mesh.axis_size(a)
            if n == 1:
                continue
            got = [None] * n
            tdist.all_gather_object(got, parts, group=self.mesh.groups[a])
            parts = [p for part in got for p in part]
        return parts

    # ---------------------------------------------------- collectives
    def _group(self):
        return self.mesh.groups[self.model_axis]

    def _reduce(self, x: torch.Tensor, axes, op: str) -> torch.Tensor:
        """All-reduce ``x`` in place over each of ``axes`` (of size > 1)
        in turn; returns it."""
        import torch.distributed as tdist
        red = getattr(tdist.ReduceOp, op.upper())
        for a in axes:
            if self.mesh.axis_size(a) > 1:
                tdist.all_reduce(x, op=red, group=self.mesh.groups[a])
        return x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) ``x`` over the model axis, in place;
        returns it."""
        if self.tp == 1:
            return x
        return self._reduce(x.contiguous(), (self.model_axis,), op)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every model-axis rank's ``x`` along ``dim``, in
        rank order."""
        if self.tp == 1:
            return x
        return _gather(x, dim, self._group(), self.tp)

    # the conjugate pairs of training: plain collectives where nothing
    # needs a gradient (serving, under torch.inference_mode)
    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model axis; the backward is the identity."""
        if self.tp == 1:
            return x
        if x.requires_grad and torch.is_grad_enabled():
            return _ReduceFromModel.apply(x, self)
        return self.all_reduce(x)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; the backward sums the gradient over the model
        axis."""
        if self.tp == 1 or not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return _CopyToModel.apply(x, self)

    def count_once(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; the backward passes 1/tp of the gradient. For a
        term every model rank computes whole (the MoE router's aux loss)
        whose gradient the model axis later sums (``copy_to_model``'s
        backward, the partial-gradient sum of a replicated leaf), so the
        sum counts it once."""
        if self.tp == 1 or not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return _CountOnce.apply(x, self.tp)

    def gather_from_model(self, x: torch.Tensor, dim: int = -1
                          ) -> torch.Tensor:
        """All-gather along ``dim``; the backward keeps this rank's
        slice."""
        if self.tp == 1:
            return x
        if x.requires_grad and torch.is_grad_enabled():
            return _GatherFromModel.apply(x, self, dim)
        return self.all_gather(x, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Sum ``x`` over the model axis and keep this rank's slice of
        ``dim`` (a new tensor)."""
        if self.tp == 1:
            return x
        return _reduce_scatter(x, dim, self._group(), self.tp)

    def seq_slice(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slice of ``dim`` (a view)."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.model_rank * n, n)

    # the sequence-parallel pairs, on dim 1 of a (B, S, D) activation
    def gather_from_seq(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather the S shards; the backward reduce-scatters."""
        if x.requires_grad and torch.is_grad_enabled():
            return _GatherFromSeq.apply(x, self)
        return self.all_gather(x, 1)

    def reduce_scatter_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter partial sums to S shards; the backward
        all-gathers."""
        if x.requires_grad and torch.is_grad_enabled():
            return _ReduceScatterToSeq.apply(x, self)
        return self.reduce_scatter(x, 1)

    def scatter_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's S shard of a whole activation; the backward
        all-gathers."""
        if x.requires_grad and torch.is_grad_enabled():
            return _ScatterToSeq.apply(x, self)
        return self.seq_slice(x)

    def to_parallel(self, x: torch.Tensor, split: bool, seq: bool
                    ) -> torch.Tensor:
        """The input of a product that is ``split`` over the model axis
        (column-parallel) or computed whole on every rank, from a stream
        that is ``seq`` split or replicated: the whole S either way."""
        if seq:
            return (self.gather_from_seq(x) if split
                    else self.gather_from_model(x, 1))
        return self.copy_to_model(x) if split else x

    def from_parallel(self, y: torch.Tensor, partial: bool, seq: bool
                      ) -> torch.Tensor:
        """The stream's share of a product's output over the whole S: the
        sum of ``partial`` (row-parallel) outputs, or one computed whole
        on every rank; this rank's S shard of it under ``seq``."""
        if seq:
            return (self.reduce_scatter_to_seq(y) if partial
                    else self.scatter_to_seq(y))
        return self.reduce_from_model(y) if partial else y

    def sum_over_model(self, grads: list[torch.Tensor]) -> None:
        """Sum tensors over the model axis, in place, in one all-reduce
        of their concatenation (the partial gradients of the replicated
        leaves that act on an S shard)."""
        if self.tp == 1 or not grads:
            return
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the batch axes, in place; returns it."""
        if self.data_size == 1:
            return x
        return self._reduce(x, self.batch_axes, "sum")

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """Average ``x`` (a gradient, a loss) over the batch axes, in
        place; returns it."""
        if self.data_size == 1:
            return x
        return self.sum_over_data(x).div_(self.data_size)

    def max_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum of ``x`` over the batch axes, in place."""
        if self.data_size == 1:
            return x
        return self._reduce(x, self.batch_axes, "max")

    def max_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum of ``x`` over every rank of the mesh, in place (one
        all-reduce per axis of size > 1): equal on all of them after, and
        a barrier."""
        return self._reduce(x, self.mesh.axis_names, "max")

    def gather_over_data(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every data rank's ``x`` (the batch axes, one at a time: a
        single data axis is one all-gather), in data-rank order."""
        parts = [x]
        for a in reversed(self.batch_axes):
            n = self.mesh.axis_size(a)
            if n == 1:
                continue
            stacked = _gather(torch.stack(parts), 0, self.mesh.groups[a], n)
            parts = list(stacked.unbind(0))
        return parts

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


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as tdist
    x = x.contiguous()
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    tdist.all_gather(parts, w, group=group)
    if x.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    """The sum of every rank's ``x``, of which this rank keeps slice
    ``rank`` of ``n`` along ``dim``: one ``reduce_scatter_single`` (named
    ``reduce_scatter_tensor`` before torch 2.13) on the chunks laid out
    rank-major."""
    import torch.distributed as tdist
    shape = list(x.shape)
    size = shape[dim] // n
    out_shape = shape[:dim] + [size] + shape[dim + 1:]
    # rank-major chunks, concatenated along dim 0 as the backends expect
    chunks = x.reshape(shape[:dim] + [n, size] + shape[dim + 1:]).movedim(
        dim, 0).contiguous().view([n * out_shape[0]] + out_shape[1:])
    out = x.new_empty(out_shape)
    rs = (getattr(tdist, "reduce_scatter_single", None)
          or tdist.reduce_scatter_tensor)
    rs(out, chunks, group=group)
    return out


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return dist.all_gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.reduce_scatter(g, 1), None


class _ReduceScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return dist.reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_gather(g, 1), None


class _ScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return dist.seq_slice(x).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_gather(g, 1), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        return dist.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_reduce(g.clone()), None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, dim):
        ctx.dist, ctx.dim, ctx.n = dist, dim, x.shape[dim]
        return dist.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.dist.model_rank
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def check_training(cfg, dist) -> None:
    """Refuse a multi-device context where the port does not run. The
    sharded train step and tensor-parallel serving cover every family:
    the attention families, dense (GLU or the two-matrix MLP, ``mlp2``),
    ``vlm``, ``audio`` (whisper), the MoE family with GLU experts (expert
    parallel: the experts split evenly over the model axis), and the
    recurrent ``ssm`` (rwkv6) and ``hybrid`` (zamba) families
    head-parallel, their heads split evenly; the train step on any
    (data, model) mesh."""
    if dist is None:
        return
    moe = cfg.family == "moe"
    if cfg.is_moe != moe or (moe and cfg.mlp_kind != "glu"):
        raise NotImplementedError(
            f"dist= covers MoE layers with GLU experts in the moe family "
            f"only, not {cfg.family!r} with mlp_kind {cfg.mlp_kind!r} "
            "(ROADMAP §1 item 4)")
    if moe and cfg.num_experts % dist.tp:
        raise NotImplementedError(
            f"expert parallelism splits the experts evenly over the model "
            f"axis: {cfg.num_experts} experts do not split {dist.tp} ways "
            "(ROADMAP §1 item 4: uneven splits)")
    heads = {"ssm": max(cfg.num_heads, cfg.pad_heads_to or 0),
             "hybrid": cfg.ssm_heads}.get(cfg.family)
    if heads is not None and heads % dist.tp:
        raise NotImplementedError(
            f"{cfg.family} runs head-parallel: its {heads} heads do not "
            f"split {dist.tp} ways (ROADMAP §1 item 4: uneven splits)")


def check_serving(cfg, dist) -> None:
    """``check_training``: serving runs on the same families, on any
    (data, model) mesh (a data group serves its rows, ``batch_rows``)."""
    check_training(cfg, dist)
