"""Logical-axis -> mesh-axis sharding rules (port of
``repro/distributed/sharding.py``).

Every parameter declares logical axis names (``ParamSpec.axes``); the
rules below map them to mesh axes. A rule is dropped automatically when
the dimension is not divisible by the mesh-axis size (e.g. 4 kv heads on
a 16-way model axis -> replicated), so one rule table serves every
architecture.

A spec is a tuple with one entry per dim: ``None`` (replicated), a mesh
axis name, or a tuple of names (split over their product, the first
name major), the contents of the reference's ``PartitionSpec``. Where
the reference hands a ``NamedSharding`` tree to GSPMD, the port slices:
``param_sharding_tree`` and ``mask_sharding_tree`` return one rank's
shard of a full tree (``distributed/context.py`` says why).

The train state's layout (``train_specs``, ``state_shardings``): every
leaf as the rules say, except that a BLaST weight splits only where its
block mask splits (the rules re-checked against the block counts), so a
rank always holds whole blocks; its Adam moments and error-feedback
buffer follow it. ``NamedSharding`` pairs a spec with its mesh, the role
the reference's ``jax.sharding.NamedSharding`` plays for
``Checkpointer.restore(shardings=)``; ``gather`` is the exact inverse of
``shard`` (every rank gets the logical array back, bitwise).

Distillation's dense teacher takes the student's layout
(``shard_teacher``: ``train_specs`` of the teacher's config), cut from
whole params once. Under sequence parallelism the replicated leaves
that act on the residual stream's S shard (``seq_partial_flags``: the
norms' scales and biases, any bias added on the residual) get only this
rank's share of their gradient, which the train step sums over the
model axis after the backward (``partial_flags``, which adds an MoE
layer's router and, under sequence parallelism, its shared experts).

The two-matrix MLP (GPT-2, whisper) splits ``w_in`` and its ``b_in``
together, exactly where ``w_in``'s block mask splits (a ``w_in`` kept
whole keeps its ``b_in`` whole); ``b_out`` is replicated and, added to
the S shard under sequence parallelism, partial. Whisper's encoder
stream splits along its own S (``partial_flags``' ``seq_enc``).

zamba's Mamba2 layers (the ``hybrid`` family) split by heads, and their
``in_proj`` (z | x | B C | dt columns) and ``conv_w``/``conv_b`` (x | B C
channels) are cut by meaning rather than in one contiguous slice, as the
reference's ``ssm_proj``/``ssm_conv`` rules would: the z, x and dt
columns and the x channels go by the rank's heads, the B and C ones
(one group, read by every head) stay whole on every rank. The leaf's
``ParamSpec.cut`` names the segments and the spec holds a ``Cut`` on
that dim; ``shard``, ``gather`` and the gradient norm
(``shard_flags``: a ``Cut`` in place of the flag) take it segment by
segment. rwkv6 (``ssm``) splits its time-mix heads and its channel-mix
by the default rules; its token-shift mixes ``mu_*`` and the decay
LoRA's ``lora_a`` stay whole and, used for the rank's heads only, hold
partial gradients (``partial_flags``), as does the channel mix's
``w_recept`` under sequence parallelism.

The MoE family is expert parallel, as the reference's ``_moe_shardmap``:
the expert stacks (and their masks and moments) split on the experts dim
alone (``experts`` takes the model axis, so ``ff`` cannot), and the
router and the shared experts ``ws_*`` (axes ``embed`` and None) stay
replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# logical axis -> candidate mesh axes (in order; all that fit are used)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "ssm_proj": ("model",),
    "ssm_conv": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "kv_seq": ("model",),     # decode-cache sequence dim
    # replicated: embed, embed2, head_dim, layers, seq, None
}


@dataclasses.dataclass(frozen=True)
class Cut:
    """A spec entry for a dim made of segments (``parts``: (global
    length, split over ``axis``) each, in order) that split on their
    own: a rank holds its slice of every split segment and the whole of
    the others, in the same order."""
    axis: str
    parts: tuple

    def local(self, n: int) -> list[int]:
        """Each segment's local length over ``n`` ranks."""
        return [k // n if split else k for k, split in self.parts]

    def shard(self, x: torch.Tensor, dim: int, i: int, n: int
              ) -> torch.Tensor:
        out, at = [], 0
        for k, split in self.parts:
            seg = x.narrow(dim, at, k)
            out.append(seg.narrow(dim, i * (k // n), k // n) if split
                       else seg)
            at += k
        return torch.cat(out, dim=dim)

    def gather(self, x: torch.Tensor, dim: int, group, n: int
               ) -> torch.Tensor:
        from repro_torch.distributed.context import _gather
        segs = x.split(self.local(n), dim=dim)
        return torch.cat([_gather(s, dim, group, n) if split else s
                          for s, (_, split) in zip(segs, self.parts)],
                         dim=dim)

    def square_sums(self, x: torch.Tensor, n: int):
        """(sum of squares over the split segments, over the whole ones)
        of a rank's block whose last dim this cut cuts."""
        sq = torch.square(x.float())
        segs = sq.split(self.local(n), dim=-1)
        zero = sq.new_zeros(())
        split = sum((s.sum() for s, (_, f) in zip(segs, self.parts) if f),
                    zero)
        whole = sum((s.sum() for s, (_, f) in zip(segs, self.parts)
                     if not f), zero)
        return split, whole


def cut_spec(spec, mesh, rules: dict | None = None) -> tuple:
    """The spec of a ``ParamSpec`` with a ``cut``: a ``Cut`` on its last
    dim where the model axis divides every split segment, else the
    leaf whole."""
    n = axis_sizes(mesh).get("model", 1)
    rules = rules or DEFAULT_RULES
    ok = n > 1 and all(k % n == 0 for k, split in spec.cut if split) \
        and "model" in rules.get(spec.axes[-1], ())
    last = Cut("model", tuple(spec.cut)) if ok else None
    return (None,) * (len(spec.shape) - 1) + (last,)


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size."""
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for(shape: tuple[int, ...], axes: tuple[Any, ...], mesh,
             rules: dict | None = None) -> tuple:
    """The spec of one array, honouring divisibility."""
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    parts: list[Any] = []
    used: set[str] = set()
    for dim, ax in zip(shape, axes):
        cand = rules.get(ax) if ax is not None else None
        if not cand:
            parts.append(None)
            continue
        chosen = []
        rem = dim
        for name in cand:
            if name in sizes and name not in used \
                    and rem % sizes[name] == 0:
                chosen.append(name)
                used.add(name)
                rem //= sizes[name]
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return tuple(parts)


def shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a full array under ``spec`` (``mesh`` a
    ``context.Mesh``): each split dim narrowed to the rank's coordinate
    over the dim's axes, first axis major. A copy where anything is
    split, so the full array can be freed; the array itself where
    nothing is."""
    coords = mesh.coords
    sizes = axis_sizes(mesh)
    out, seen = x, set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, Cut):
            seen.add(entry.axis)
            n = sizes.get(entry.axis, 1)
            if n > 1:
                out = entry.shard(out, dim, coords[entry.axis], n)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if seen & set(names):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        seen |= set(names)
        n = math.prod(sizes[a] for a in names)
        if n == 1:
            continue
        i = 0
        for a in names:
            i = i * sizes[a] + coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split {n} ways")
        step = x.shape[dim] // n
        out = out.narrow(dim, i * step, step)
    if out is x:
        return x
    return out.clone(memory_format=torch.contiguous_format)


def gather(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full array of which ``x`` is this rank's block under ``spec``
    (the inverse of ``shard``): each split dim all-gathered over its
    axes, the minor axis first. Every rank of those axes gets it."""
    from repro_torch.distributed.context import _gather
    sizes = axis_sizes(mesh)
    out = x
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, Cut):
            n = sizes.get(entry.axis, 1)
            if n > 1:
                out = entry.gather(out, dim, mesh.groups[entry.axis], n)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in reversed(names):
            if sizes[a] > 1:
                out = _gather(out, dim, mesh.groups[a], sizes[a])
    return out


def model_sharded(spec: tuple, axis: str = "model") -> bool:
    """Whether ``spec`` splits a dim over ``axis`` (a ``Cut`` splits
    part of one)."""
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               or (isinstance(e, Cut) and e.axis == axis)
               for e in spec if e is not None)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``shard`` takes this rank's block of a logical
    array, ``gather`` gives the logical array back."""
    mesh: Any
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard(x, self.spec, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather(x, self.spec, self.mesh)


def _map_specs(fn, specs):
    from repro_torch.models.params import ParamSpec
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def param_specs_tree(param_specs: dict, mesh,
                     rules: dict | None = None) -> dict:
    """Spec tree parallel to a ``ParamSpec`` tree (a leaf with a ``cut``
    takes ``cut_spec``)."""
    return _map_specs(lambda s: cut_spec(s, mesh, rules) if s.cut
                      else spec_for(s.shape, s.axes, mesh, rules),
                      param_specs)


def param_sharding_tree(params: dict, param_specs: dict, mesh,
                        rules: dict | None = None) -> dict:
    """One rank's shard of a full parameter tree (dense leaves, shaped as
    its ``ParamSpec`` tree says)."""
    specs = param_specs_tree(param_specs, mesh, rules)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return shard(p, s, mesh)
    return walk(params, specs)


def mask_sharding_tree(masks: dict, weight_axes: dict,
                       sparse_paths: list[str], mesh,
                       rules: dict | None = None) -> dict:
    """One rank's shard of a mask tree: masks shard like their weights
    (block dims inherit the weight's logical axes; divisibility is
    re-checked against the block counts)."""
    from repro_torch.core.sparse_mlp import get_path
    out = {}
    for path in sparse_paths:
        arr = masks[path]
        out[path] = shard(arr, spec_for(tuple(arr.shape),
                                        get_path(weight_axes, path), mesh,
                                        rules), mesh)
    return out


def train_specs(cfg, mesh) -> dict:
    """Specs of the train state's params and masks: ``{"params": spec
    tree, "masks": {path: spec}}``, from ``training/step.py::
    abstract_state``. A mask shards like its weight with divisibility
    re-checked on the block counts, and its weight then takes the mask's
    spec, so each rank holds whole blocks."""
    from repro_torch.core.sparse_mlp import get_path, set_path
    from repro_torch.models import registry
    from repro_torch.training.step import abstract_state
    st = abstract_state(cfg)
    axes = registry.axes_tree(cfg)
    params = param_specs_tree(registry.param_specs(cfg), mesh)
    masks = {}
    for path, m in st.masks.items():
        masks[path] = spec_for(tuple(m.shape), get_path(axes, path), mesh)
        params = set_path(params, path, masks[path])
        if path.endswith("/w_in"):
            # the two-matrix MLP's b_in splits exactly where w_in's
            # columns do (a w_in kept whole keeps its b_in whole)
            params = set_path(params, path[:-len("w_in")] + "b_in",
                              masks[path][:-2] + masks[path][-1:])
    return {"params": params, "masks": masks}


def _named(specs, mesh):
    if isinstance(specs, dict):
        return {k: _named(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def state_shardings(cfg, mesh):
    """A ``TrainState`` of ``NamedSharding`` trees for the params and the
    masks; every optimizer buffer ('m', 'v', the deferred step's 'ef')
    follows the params, so ``opt_state`` is None, and so are ``step`` and
    ``generator`` (not arrays)."""
    from repro_torch.training.step import TrainState
    sp = train_specs(cfg, mesh)
    return TrainState(step=None, params=_named(sp["params"], mesh),
                      opt_state=None, masks=_named(sp["masks"], mesh),
                      generator=None)


def shard_teacher(cfg, params, mesh):
    """This rank's shard of a whole dense teacher tree, in the layout of
    ``train_specs`` (``cfg`` the teacher's config), so the teacher's
    forward runs on the shards a student of that config holds. Split
    leaves are copies, so the whole tree can be freed."""
    return shard_tree(params, _named(train_specs(cfg, mesh)["params"], mesh))


def seq_partial_flags(cfg) -> dict:
    """Per leaf of the params tree: whether it is a replicated leaf that
    acts on the residual stream (every logical axis but the layer stack's
    is ``embed``: the pre-attention, pre-MLP and final norms' scales and
    biases, and any bias added on the residual). Under sequence
    parallelism each rank applies it to its S shard only, so its
    gradient is a partial sum over the model axis."""
    from repro_torch.models import registry

    def walk(axes):
        if isinstance(axes, dict):
            return {k: walk(v) for k, v in axes.items()}
        rest = [a for a in axes if a != "layers"]
        return bool(rest) and all(a == "embed" for a in rest)
    return walk(registry.axes_tree(cfg))


def partial_flags(cfg, seq: bool, seq_enc: bool | None = None) -> dict:
    """Per leaf of the params tree: whether a replicated leaf's gradient
    on a rank is only its share of a sum over the model axis, which the
    train step adds up after the backward. With ``seq`` (the stream split
    along S) the leaves of ``seq_partial_flags``; an MoE layer's router
    always (a rank's gradient reaches it through its own experts' gates
    only; the aux term's whole gradient is passed back at 1/tp,
    ``DistContext.count_once``); its shared experts ``ws_*`` with ``seq``
    (each rank applies them to its S shard; without, to the whole
    replicated stream, so their gradient is whole). Whisper's encoder
    stream splits on its own (``seq_enc``, the frames' S; default
    ``seq``): its stack and final norm follow it. Whisper's learned
    positions are added to the whole sequence before the split, so
    their gradient is whole (not flagged: their axes hold None). rwkv6's
    time-mix ``mu_*`` and ``lora_a`` always (they feed the rank's heads
    only), and with ``seq`` its channel-mix ``w_recept`` (applied to the
    S shard)."""
    def leaf(flag, path, seq):
        name = path[-1]
        return ((seq and flag) or (cfg.is_moe and name == "router")
                or (seq and cfg.is_moe and name.startswith("ws_"))
                or (cfg.family == "ssm" and "tmix" in path
                    and (name.startswith("mu_") or name == "lora_a"))
                or (seq and cfg.family == "ssm" and name == "w_recept"))

    def walk(flags, path, seq):
        if isinstance(flags, dict):
            return {k: walk(v, path + (k,),
                            seq_enc if k in _ENCODER_KEYS else seq)
                    for k, v in flags.items()}
        return leaf(flags, path, seq)
    seq_enc = seq if seq_enc is None else seq_enc
    return walk(seq_partial_flags(cfg), (), seq)


# whisper's leaves that act on the encoder's stream
_ENCODER_KEYS = ("encoder", "ln_enc_f_scale", "ln_enc_f_bias")


def _zip_map(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    return fn(shardings, tree)


def shard_tree(tree, shardings):
    """This rank's block of every leaf of a logical tree."""
    return _zip_map(lambda s, x: s.shard(x), tree, shardings)


def gather_tree(tree, shardings, then=None):
    """The logical tree of a sharded one (collective: every rank calls
    it, in the same order). ``then`` maps each whole leaf as soon as it
    is gathered (say, to host memory, or to None on a rank that keeps
    nothing), so the device holds one whole leaf at a time beyond the
    shards."""
    then = then or (lambda t: t)
    return _zip_map(lambda s, x: then(s.gather(x)), tree, shardings)


def _map_state(fn, state, shardings):
    opt = {k: fn(v, shardings.params) for k, v in state.opt_state.items()}
    return dataclasses.replace(state, params=fn(state.params,
                                                shardings.params),
                               opt_state=opt,
                               masks=fn(state.masks, shardings.masks))


def shard_state(state, shardings):
    """This rank's block of a logical ``TrainState``."""
    return _map_state(shard_tree, state, shardings)


def gather_state(state, shardings, then=None):
    """The logical ``TrainState`` of this rank's block (collective;
    ``then`` as in ``gather_tree``)."""
    return _map_state(lambda t, s: gather_tree(t, s, then), state,
                      shardings)


def shard_flags(tree_of_shardings, axis: str = "model"):
    """Per leaf: whether it is split over ``axis`` (a norm counts such a
    leaf's square sum on every rank, a replicated one once); the
    ``CutFlag`` of a leaf with a ``Cut`` on ``axis``, split in part."""
    if isinstance(tree_of_shardings, dict):
        return {k: shard_flags(v, axis) for k, v in tree_of_shardings.items()}
    spec = tree_of_shardings.spec
    cut = next((e for e in spec if isinstance(e, Cut) and e.axis == axis),
               None)
    if cut is not None:
        return CutFlag(cut, axis_sizes(tree_of_shardings.mesh)[axis])
    return model_sharded(spec, axis)


@dataclasses.dataclass(frozen=True)
class CutFlag:
    """``shard_flags``' entry for a leaf whose last dim holds a ``Cut``
    over ``n`` ranks: ``square_sums`` parts its square sum into the split
    segments' (summed over the model axis) and the whole ones' (counted
    once)."""
    cut: Cut
    n: int

    def square_sums(self, x: torch.Tensor):
        return self.cut.square_sums(x, self.n)


def slice_batch(batch: dict, dist, microbatches: int = 1) -> dict:
    """This data rank's rows of a global batch, so that its microbatch
    ``i`` is its slice of the global microbatch ``i`` (as GSPMD shards
    the reference's reshaped batch). Scalars (the fault-injection ones)
    pass unchanged."""
    d, r = dist.data_size, dist.data_rank
    if d == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v) or v.dim() == 0:
            out[k] = v
            continue
        b = v.shape[0]
        if b % (d * microbatches):
            raise ValueError(f"batch {b} does not split into {d} data "
                             f"ranks x {microbatches} microbatches")
        n = microbatches
        per = b // (n * d)
        out[k] = v.reshape(n, b // n, *v.shape[1:]).narrow(
            1, r * per, per).reshape(n * per, *v.shape[1:])
    return out


def batch_pspec(mesh) -> tuple:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return (tuple(axes) if len(axes) > 1 else axes[0],)


def batch_sharding(mesh, ndim: int, batch_dim: int | None = None) -> tuple:
    """Batch over the data axes; with ``batch_dim`` given, axes that do
    not divide it are dropped (long_500k has global_batch=1)."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    if batch_dim is not None:
        chosen, got = [], 1
        for a in axes:
            if (batch_dim // got) % sizes[a] == 0:
                chosen.append(a)
                got *= sizes[a]
        axes = chosen
    first = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)
    return (first,) + (None,) * (ndim - 1)


def cache_sharding(mesh, shape: tuple[int, ...], seq_axis: int = 2) -> tuple:
    """KV caches (L, B, S, KV, hd): batch over the data axes, S over model
    (both only when divisible)."""
    sizes = axis_sizes(mesh)
    parts: list[Any] = [None] * len(shape)
    baxes = [a for a in ("pod", "data") if a in sizes
             and shape[1] % sizes[a] == 0]
    # use as many batch axes as divide
    got = 1
    chosen = []
    for a in baxes:
        if (shape[1] // got) % sizes[a] == 0:
            chosen.append(a)
            got *= sizes[a]
    if chosen:
        parts[1] = tuple(chosen) if len(chosen) > 1 else chosen[0]
    if len(shape) > seq_axis and "model" in sizes \
            and shape[seq_axis] % sizes["model"] == 0:
        parts[seq_axis] = "model"
    return tuple(parts)


def count_bytes(tree) -> int:
    """Bytes of every leaf of a tree: tensors, ``PackedBCSC``s (blocks
    and idx) and abstract leaves (``shape`` and ``dtype``)."""
    from repro_torch.core.packing import PackedBCSC
    if isinstance(tree, dict):
        return sum(count_bytes(v) for v in tree.values())
    if isinstance(tree, PackedBCSC):
        return count_bytes(tree.blocks) + count_bytes(tree.idx)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return math.prod(tree.shape) * tree.dtype.itemsize
