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
"""
from __future__ import annotations

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
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if seen & set(names):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        seen |= set(names)
        n = math.prod(sizes[a] for a in names)
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


def _map_specs(fn, specs):
    from repro_torch.models.params import ParamSpec
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def param_specs_tree(param_specs: dict, mesh,
                     rules: dict | None = None) -> dict:
    """Spec tree parallel to a ``ParamSpec`` tree."""
    return _map_specs(lambda s: spec_for(s.shape, s.axes, mesh, rules),
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
