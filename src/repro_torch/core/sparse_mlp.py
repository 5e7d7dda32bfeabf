"""Block-sparse MLP forward and mask-tree management (port of
``repro/core/sparse_mlp.py``).

Training ("masked dense"): the forward multiplies each sparse weight by
its expanded block mask through ``apply_mask_ste``, whose backward hands
the FULL dense gradient to the weight: the dense gradient is what scores
the grow step, and the optimizer masks it before the update (RigL
semantics). Serving: packed weights (``PackedBCSC``) go through
``kernels/ops.py``, one fused GLU kernel and one BSpMM.

Mask trees map a param-tree path (``layers/mlp/w_gate``) to a bool block
mask stacked like the weight; ``dense_last`` layers keep all blocks
through per-layer dense flags.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import topk
from repro_torch.core.packing import PackedBCSC
from repro_torch.core.prune_grow import (BlastSpec, generate_mask,
                                         mask_from_scores, prune_weight,
                                         zero_grown)
from repro_torch.core.schedule import is_refresh_step

Params = dict
MaskTree = dict  # path -> bool block mask, stacked like the weight


class _MaskSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, block_mask, b_in, b_out):
        return topk.apply_block_mask(w, block_mask, b_in, b_out)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def apply_mask_ste(w: torch.Tensor, block_mask: torch.Tensor, b_in: int,
                   b_out: int) -> torch.Tensor:
    """w * expand(mask); the backward passes the dense (unmasked)
    gradient."""
    return _MaskSTE.apply(w, block_mask, b_in, b_out)

# BlastSpec.b_in tiles the d_model side and b_out the d_ff side of EVERY
# matrix: up-projections (D, F) use (b_in, b_out), down-projections (F, D)
# the swapped (b_out, b_in). The orientation follows the leaf name.
_SWAPPED_LEAVES = ("w_down", "w_out", "ws_down")


def block_dims_for(spec: BlastSpec, path: str) -> tuple[int, int]:
    leaf = path.split("/")[-1]
    if leaf in _SWAPPED_LEAVES:
        return spec.b_out, spec.b_in
    return spec.b_in, spec.b_out


def maybe_mask(w: torch.Tensor, mask: torch.Tensor | None,
               spec: BlastSpec | None, swapped: bool = False) -> torch.Tensor:
    if mask is None or spec is None or not spec.enabled:
        return w
    bi, bo = (spec.b_out, spec.b_in) if swapped else (spec.b_in, spec.b_out)
    return apply_mask_ste(w, mask, bi, bo)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def glu_mlp(x, w_gate, w_up, w_down, *, act="silu", masks=None,
            spec: BlastSpec | None = None, dist=None, d_ff: int = 0,
            seq: bool = False):
    """(act(x W_g) * (x W_u)) W_d — paper Eq. (1) for silu. ``masks``:
    optional block masks keyed 'w_gate', 'w_up', 'w_down', applied
    through the STE before the cast to x's dtype. Packed weights
    dispatch to the fused BSpMM path over (M, d) rows. ``dist`` (with
    the model's ``d_ff``) takes the tensor-parallel path,
    ``_glu_mlp_tp``, masked or not; with ``seq`` its input and output
    are this rank's S shard of a (B, S, D) stream."""
    if dist is not None and dist.tp > 1:
        return _glu_mlp_tp(x, w_gate, w_up, w_down, act, dist, d_ff, masks,
                           spec, seq)
    if isinstance(w_gate, PackedBCSC):
        from repro_torch.kernels import ops
        y = ops.sparse_mlp_apply(_flat(x), w_gate, w_up, w_down, act=act)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    m = masks or {}
    dt = x.dtype
    wg = maybe_mask(w_gate, m.get("w_gate"), spec).to(dt)
    wu = maybe_mask(w_up, m.get("w_up"), spec).to(dt)
    wd = maybe_mask(w_down, m.get("w_down"), spec, swapped=True).to(dt)
    h = act_fn(act)(x @ wg) * (x @ wu)
    return h @ wd


def _glu_mlp_tp(x, w_gate, w_up, w_down, act, dist, d_ff, masks=None,
                spec=None, seq=False):
    """One rank's GLU under tensor parallelism, its output replicated.

    Packed (the layout of ``serving/export.py::shard_params``): the
    fused GLU kernel on the rank's gate/up block-columns; an all-gather
    of its output (M, d_ff), in rank order, where those columns are
    split; ``bspmm`` over the whole of it with the rank's share of
    ``w_down``'s kept blocks, whose visit lists reach K blocks anywhere
    in d_ff; an all-reduce of the partial sums where that share is one
    (``PackedBCSC.partial``). The kernel wrappers see shard-local
    packs. Dense (serving, or training with ``masks`` through the STE on
    the rank's mask shards): gate and up column-parallel behind
    ``copy_to_model``, down row-parallel, then ``reduce_from_model``,
    where this rank holds a d_ff slice (the train state splits d_ff only
    in whole blocks, ``sharding.train_specs``); otherwise every rank
    computes the whole MLP.

    With ``seq`` (sequence parallelism) ``x`` is this rank's S shard of
    a (B, S, D) stream: it is gathered along S first (so the kernels see
    M = B·S rows, as without), and the output's sum over the model axis
    is reduce-scattered back to the shard (a whole output is sliced);
    ``DistContext.to_parallel`` / ``from_parallel``."""
    if isinstance(w_gate, PackedBCSC):
        from repro_torch.kernels import ops
        x = dist.to_parallel(x, True, seq)
        h = ops.fused_glu(_flat(x), w_gate, w_up, act=act)
        if h.shape[-1] < w_down.kb * w_down.b_in:
            h = dist.all_gather(h, dim=-1)
        y = ops.bspmm(h, w_down)
        return dist.from_parallel(y.reshape(*x.shape[:-1], y.shape[-1]),
                                  w_down.partial, seq)
    dt = x.dtype
    split = w_gate.shape[-1] < d_ff
    x = dist.to_parallel(x, split, seq)
    m = masks or {}
    wg = maybe_mask(w_gate, m.get("w_gate"), spec).to(dt)
    wu = maybe_mask(w_up, m.get("w_up"), spec).to(dt)
    wd = maybe_mask(w_down, m.get("w_down"), spec, swapped=True).to(dt)
    y = (act_fn(act)(x @ wg) * (x @ wu)) @ wd
    return dist.from_parallel(y, split, seq)


def mlp2(x, w_in, w_out, b_in_=None, b_out_=None, *, act="gelu",
         masks=None, spec: BlastSpec | None = None, square: bool = False,
         dist=None, d_ff: int = 0, seq: bool = False):
    """Two-matrix MLP (GPT-2): act(x W1 + b1) W2 + b2; ``square`` squares
    the activation; ``masks`` keyed 'w_in', 'w_out'. ``dist`` (with the
    model's ``d_ff``) takes the tensor-parallel path, ``_mlp2_tp``; with
    ``seq`` its input and output are this rank's S shard."""
    if dist is not None and dist.tp > 1:
        return _mlp2_tp(x, w_in, w_out, b_in_, b_out_, act, square, dist,
                        d_ff, masks, spec, seq)
    dt = x.dtype
    packed = isinstance(w_in, PackedBCSC)
    m = masks or {}
    if packed:
        from repro_torch.kernels import ops
        h = ops.bspmm(_flat(x), w_in)
    else:
        w_out = maybe_mask(w_out, m.get("w_out"), spec, swapped=True)
        h = x @ maybe_mask(w_in, m.get("w_in"), spec).to(dt)
    if b_in_ is not None:
        h = h + b_in_.to(h.dtype)
    h = act_fn(act)(h)
    if square:
        h = h * h
    y = ops.bspmm(h, w_out) if packed else h @ w_out.to(dt)
    if b_out_ is not None:
        y = y + b_out_.to(y.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _mlp2_tp(x, w_in, w_out, b_in_, b_out_, act, square, dist, d_ff,
             masks=None, spec=None, seq=False):
    """One rank's two-matrix MLP under tensor parallelism, the layout of
    ``_glu_mlp_tp``: packed, ``bspmm`` on the rank's ``w_in``
    block-columns plus its slice of ``b_in`` (``b_in`` splits exactly
    where ``w_in`` does), an all-gather of the activation where those
    columns are split, ``bspmm`` with the rank's share of ``w_out``'s
    kept blocks, the sum of partial outputs; dense (serving, or training
    through the STE on the rank's mask shards), ``w_in`` column-parallel
    and ``w_out`` row-parallel where this rank holds a d_ff slice, else
    the whole MLP on every rank. ``b_out`` is added once, after the sum
    over the model axis (added to each rank's partial sum it would count
    tp times)."""
    if isinstance(w_in, PackedBCSC):
        from repro_torch.kernels import ops
        x = dist.to_parallel(x, True, seq)
        h = ops.bspmm(_flat(x), w_in)
    else:
        dt = x.dtype
        split = w_in.shape[-1] < d_ff
        x = dist.to_parallel(x, split, seq)
        m = masks or {}
        h = x @ maybe_mask(w_in, m.get("w_in"), spec).to(dt)
    if b_in_ is not None:
        h = h + b_in_.to(h.dtype)
    h = act_fn(act)(h)
    if square:
        h = h * h
    if isinstance(w_out, PackedBCSC):
        if h.shape[-1] < w_out.kb * w_out.b_in:
            h = dist.all_gather(h, dim=-1)
        y = ops.bspmm(h, w_out)
        partial = w_out.partial
    else:
        y = h @ maybe_mask(w_out, m.get("w_out"), spec, swapped=True).to(dt)
        partial = split
    y = dist.from_parallel(y.reshape(*x.shape[:-1], y.shape[-1]), partial,
                           seq)
    if b_out_ is not None:
        y = y + b_out_.to(y.dtype)
    return y


def get_path(tree: Params, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def set_path(tree: Params, path: str, value) -> Params:
    """Functional set (copies the dicts along the path). A loop, not a
    recursive closure: a closure that refers to itself is a reference
    cycle holding ``value``, which only the garbage collector frees, so
    the leaves an export replaces (masked f32 copies, GBs each) would
    outlive it."""
    *head, last = path.split("/")
    out = node = dict(tree)
    for k in head:
        node[k] = dict(node[k])
        node = node[k]
    node[last] = value
    return out


def _dense_flag_mask(new_mask: torch.Tensor, dense_flags, path: str = ""):
    """Force an all-kept mask on layers whose dense flag is set.

    new_mask: (L, ..., Kb, Nb); dense_flags: (L,) bool, a dict keyed by
    stack prefix, or None."""
    if isinstance(dense_flags, dict):
        dense_flags = dense_flags.get(path.split("/")[0])
    if dense_flags is None:
        return new_mask
    shape = (-1,) + (1,) * (new_mask.dim() - 1)
    flags = dense_flags.to(new_mask.device).reshape(shape)
    return torch.where(flags, True, new_mask)


def init_masks(spec: BlastSpec, params: Params,
               sparse_paths: list[str]) -> MaskTree:
    """All-kept initial masks (s_init=0) for every declared sparse
    weight, on the weights' devices."""
    masks: MaskTree = {}
    for path in sparse_paths:
        w = get_path(params, path)
        bi, bo = block_dims_for(spec, path)
        masks[path] = torch.ones(
            tuple(w.shape[:-2]) + (w.shape[-2] // bi, w.shape[-1] // bo),
            dtype=torch.bool, device=w.device)
    return masks


def _sharded_mask(spec: BlastSpec, w, g, step: int, dist, mspec: tuple):
    """One weight's refresh on this rank's shard: the selection that one
    device makes, restricted to this rank's blocks. Balanced selection
    ranks each block-column, so where the columns split (gate/up) the
    rank's own scores suffice; where the rows split (down) or the
    selection is global, the block scores (f32, one per block) are
    gathered over the model axis, ranked by the one-device code (stable,
    ties to the lower global index) and this rank's part kept."""
    from repro_torch.distributed import sharding as shd
    wn = topk.block_norms(w, spec.b_in, spec.b_out)
    gn = topk.block_norms(g, spec.b_in, spec.b_out)
    split = {i for i, e in enumerate(mspec)
             if shd.model_sharded((e,), dist.model_axis)}
    if not split or (spec.selection == "balanced"
                     and wn.dim() - 2 not in split):
        return mask_from_scores(spec, wn, gn, step)
    both = shd.gather(torch.stack([wn, gn]), (None,) + tuple(mspec),
                      dist.mesh)
    return shd.shard(mask_from_scores(spec, both[0], both[1], step), mspec,
                     dist.mesh)


def refresh_masks(spec: BlastSpec, params: Params, dense_grads: Params,
                  masks: MaskTree, step: int, dense_flags=None, dist=None,
                  mask_specs: dict | None = None):
    """generate_masks() + prune_weights() of paper Listing 1 over the
    whole mask tree, from the old params and the dense gradients.
    Returns (new_masks, pruned_params, grown_masks); the params tree is
    copied along the changed paths, the given one is not modified. Under
    ``dist`` the trees are this rank's shards and ``mask_specs`` their
    layout (``sharding.train_specs``): the masks come out as the
    one-device masks' shards (``_sharded_mask``)."""
    new_masks: MaskTree = {}
    grown: MaskTree = {}
    new_params = params
    for path, old in masks.items():
        w = get_path(params, path)
        bi, bo = block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        g = get_path(dense_grads, path)
        if dist is not None and dist.tp > 1:
            nm = _sharded_mask(pspec, w, g, step, dist, mask_specs[path])
        else:
            nm = generate_mask(pspec, w, g, step)
        nm = _dense_flag_mask(nm, dense_flags, path)
        gr = nm & ~old
        new_masks[path] = nm
        grown[path] = gr
        new_params = set_path(new_params, path, zero_grown(
            pspec, prune_weight(pspec, w, nm), gr))
    return new_masks, new_params, grown


def maybe_refresh(spec: BlastSpec, params, dense_grads, masks, step: int,
                  dense_flags=None, dist=None, mask_specs=None):
    """Refresh every ``spec.step_size`` steps. ``step`` is a host int, so
    this is a Python branch with no device read (every rank takes the
    same one). Returns (masks, params, grown); ``grown`` is all-False
    when no refresh ran."""
    if spec.enabled and is_refresh_step(step, spec.step_size):
        return refresh_masks(spec, params, dense_grads, masks, step,
                             dense_flags, dist, mask_specs)
    return masks, params, {p: torch.zeros_like(m) for p, m in masks.items()}


def mask_grads(masks: MaskTree, grads: Params, spec: BlastSpec) -> Params:
    """Apply the masks to the dense gradients before the optimizer."""
    out = grads
    for path, m in masks.items():
        bi, bo = block_dims_for(spec, path)
        out = set_path(out, path, topk.apply_block_mask(
            get_path(grads, path), m, bi, bo))
    return out


def tree_sparsity(masks: MaskTree, dist=None,
                  sharded: dict | None = None) -> torch.Tensor:
    """Overall fraction of pruned blocks across the mask tree (a float32
    device scalar: reading it is the caller's sync). Under ``dist`` the
    masks are shards: ``sharded`` (path -> split over the model axis)
    says which count summed over the model axis and which once."""
    if dist is None or dist.tp == 1:
        tot = sum(m.numel() for m in masks.values())
        kept = sum(m.sum() for m in masks.values())
        return 1.0 - kept / tot
    tot = sum(m.numel() * (dist.tp if sharded[p] else 1)
              for p, m in masks.items())
    split = sum(m.sum() for p, m in masks.items() if sharded[p])
    rep = sum(m.sum() for p, m in masks.items() if not sharded[p])
    if torch.is_tensor(split):
        rep = rep + dist.all_reduce(split.clone())
    return 1.0 - rep / tot
