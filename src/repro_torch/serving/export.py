"""Export pruned weights for serving (port of ``repro/serving/export.py``):

  * ``prune_params`` — bake masks into the weights (zeros in pruned
    blocks) and cast f32 leaves to bf16: the dense serving layout;
  * ``pack_params``  — replace every sparse weight with its balanced-BCSC
    ``PackedBCSC``, marking gate/up pairs with one idx table ``joint``;
    layer-stacked leaves pack per layer in one pass, and a 2-D leaf (zamba's
    one shared MLP) packs as a single matrix;
  * ``memory_report`` — bytes of the serving weights;
  * ``shard_params`` — one rank's shard of a serving tree for
    tensor-parallel serving over the ``model`` axis, and
    ``abstract_packed_params`` the shapes and specs of that layout.

The tensor-parallel pack follows the reference's layout
(``abstract_packed_params``) bit for bit:

  * gate and up (``w_gate``/``w_up``): the column-block dim ``nb`` splits
    over the model axis where it divides it, so each rank's fused GLU
    produces its own d_ff/tp columns;
  * the swapped leaves (``w_down``; the d_ff x d_model down projection,
    whose column-blocks are d_model's and often do not split): the
    kept-block (nnz, contraction) dim splits instead, first padded with
    zero blocks at idx 0 to ``ceil(nnz / tp) * tp`` where ``nnz >= tp``
    (else the pack is replicated). A rank's visit lists then reach K
    blocks anywhere in d_ff, so the layer all-gathers the GLU output
    (M x d_ff, in rank order) before ``bspmm`` and all-reduces
    ``bspmm``'s partial sums (``PackedBCSC.partial``);
  * the two-matrix MLP (``mlp2``: GPT-2, whisper's two stacks): ``w_in``
    splits on ``nb`` as gate and up do, with ``b_in`` sliced alike;
    ``w_out`` is a swapped leaf and splits on ``nnz``; ``b_out`` stays
    whole and is added once, after the sum (``sparse_mlp._mlp2_tp``).
    whisper-large-v3 at s = 0.8 (blocks of 128 x 64, d_model x d_ff):
    ``w_in`` has 80 block-columns, 40 a rank; ``w_out`` keeps 16 of 80
    blocks in each of its 10 columns, 8 a rank;
  * an MoE layer's expert packs (a leading experts dim): that dim alone
    splits, each rank keeping the E/tp experts it computes, with whole
    visit lists (no padding, not partial), as the reference's
    ``_moe_shardmap`` shards them (its ``abstract_packed_params`` would
    put the model axis on ``nb`` or ``nnz`` as well); the shared experts'
    packs (weights on ``embed`` x None axes) stay whole on every rank;
  * rwkv6's channel mix packs as the two-matrix MLP's (``w_in`` on
    ``nb``, ``w_out`` on ``nnz``; rwkv6-3b at s = 0.8, 128 x 16 and
    16 x 128 blocks: 280 of ``w_in``'s 560 block-columns a rank, 56 of
    ``w_out``'s 112 kept blocks a column), zamba's one shared GLU and its
    down projection as the dense GLU's;
  * every other leaf as ``distributed/sharding.py``'s rules say (query
    and kv heads, the vocabulary, rwkv6's time-mix heads; norms
    replicated), zamba's ``in_proj`` and conv by their ``Cut``.

Per layer of Llama-3.2-1B at s = 0.8 (128 x 128 blocks, bf16), tp 2: gate
and up keep 4 of 16 blocks in each of 64 columns, 8.4 MB each, 4.2 MB a
rank; down keeps 13 of 64 in each of 16 columns, 6.8 MB, padded to 14 and
3.7 MB a rank; attention's 21 MB of wq/wk/wv/wo halve with the heads.
The collectives of a layer call on M rows: an all-reduce of M x 2048
after ``wo``, an all-gather of M x 8192 (M x 4096 from each rank) after
the GLU, an all-reduce of M x 2048 after ``bspmm``; a forward adds one
all-reduce of M x 2048 for the embedding, and the greedy token one
all-gather of 3 x B values (``DistContext.vocab_argmax``).

The other layout: a K-range split of ``w_down`` (each rank keeps the kept
blocks whose block-row falls in the d_ff/tp range its own GLU columns
produce) needs one all-reduce and no all-gather, but its visit lists are
unbalanced, since a column's kept blocks need not fall evenly into the
ranges; choosing between the two is performance work for later.

Every function walks the tree by its sparse paths and dicts alone, so
whisper's nested stacks (``encoder/mlp/w_in`` ... ``decoder/mlp/w_out``)
take the same walk as a transformer's ``layers``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from repro_torch.core import packing, sparse_mlp as sm, topk
from repro_torch.distributed import sharding as shd


class UnbalancedMaskWarning(UserWarning):
    """A mask handed to ``pack_params`` keeps fewer blocks in some
    block-columns than the max, so the pack zero-pads them (exact, but
    the memory saving shrinks by the pad fraction)."""


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def prune_params(cfg, params, masks, dtype=torch.bfloat16):
    out = params
    for path, m in masks.items():
        w = sm.get_path(params, path)
        bi, bo = sm.block_dims_for(cfg.blast, path)
        out = sm.set_path(out, path, topk.apply_block_mask(w, m, bi, bo))
    return _map_tensors(
        lambda x: x.to(dtype) if x.dtype == torch.float32 else x, out)


def pack_params(cfg, params, masks, dtype=torch.bfloat16,
                unbalanced: str = "warn", pad_report: dict | None = None):
    """Sparse leaves -> PackedBCSC with static nnz = max kept per column.

    ``unbalanced``: "warn" (``UnbalancedMaskWarning``), "raise"
    (``ValueError``) or "ignore" for masks that pad; ``pad_report`` is
    filled path -> pad fraction for every padded path."""
    if unbalanced not in ("warn", "raise", "ignore"):
        raise ValueError(f"unbalanced={unbalanced!r}: expected "
                         "'warn', 'raise' or 'ignore'")
    pruned = prune_params(cfg, params, masks, dtype)
    out = pruned
    for path, m in masks.items():
        w = sm.get_path(pruned, path)
        bi, bo = sm.block_dims_for(cfg.blast, path)
        counts = m.sum(dim=-2).cpu().numpy()
        nnz = int(counts.max())
        frac = packing.pad_fraction(m, nnz)
        if frac > 0.0:
            if pad_report is not None:
                pad_report[path] = frac
            msg = (f"mask for {path!r} is unbalanced: {frac:.1%} of "
                   f"packed block slots are zero padding (nnz={nnz}, "
                   f"min per-column count {int(counts.min())})")
            if unbalanced == "raise":
                raise ValueError(msg)
            if unbalanced == "warn":
                warnings.warn(msg, UnbalancedMaskWarning, stacklevel=2)
        out = sm.set_path(out, path, packing.pack(w, m, bi, bo, nnz))
    for gpath in masks:
        leaf = gpath.split("/")[-1]
        if leaf not in ("w_gate", "ws_gate"):
            continue
        upath = gpath[:-len(leaf)] + leaf.replace("gate", "up")
        if upath not in masks:
            continue
        pg, pu = packing.mark_joint(sm.get_path(out, gpath),
                                    sm.get_path(out, upath))
        out = sm.set_path(out, gpath, pg)
        out = sm.set_path(out, upath, pu)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def memory_report(cfg, params_or_packed) -> dict:
    """Bytes of the serving weights, and how many 80 GB cards they need."""
    total = 0
    for leaf in _leaves(params_or_packed):
        if isinstance(leaf, packing.PackedBCSC):
            total += packing.storage_bytes(leaf)
        else:
            total += leaf.numel() * leaf.element_size()
    return {"bytes": int(total), "GiB": total / 2**30,
            "gpus_80GB": int(np.ceil(total / (80 * 2**30)))}


def _packed_layout(path: str, nb: int, nnz: int, tp: int
                   ) -> tuple[str | None, int]:
    """(the split dim of a pack, "nb", "nnz" or None, and its nnz after
    the zero-block padding) over a model axis of ``tp``: the reference's
    rules in ``abstract_packed_params``."""
    swapped = path.split("/")[-1] in sm._SWAPPED_LEAVES
    if swapped and nnz >= tp:
        nnz = math.ceil(nnz / tp) * tp
    if swapped and nnz % tp == 0:
        return "nnz", nnz
    if not swapped and nb % tp == 0:
        return "nb", nnz
    return None, nnz


def _packed_specs(path: str, lead: tuple[int, ...], waxes, nb: int, nnz: int,
                  mesh) -> tuple[tuple, tuple, int, str | None]:
    """(blocks spec, idx spec, padded nnz, the split: "experts", "nb",
    "nnz" or None) of a pack with leading dims ``lead`` whose dense
    weight has logical axes ``waxes``. A pack whose leading experts dim
    takes the model axis splits there alone, with whole visit lists (the
    reference's ``_moe_shardmap``; its ``abstract_packed_params`` would
    name the model axis twice); a pack whose matrix the rules never split
    (an MoE layer's shared experts, ``embed`` x None) stays whole."""
    lead_parts = tuple(shd.spec_for((lead[i],), (waxes[i],), mesh)[0]
                       for i in range(len(lead)))
    none = lead_parts + (None,) * 4, lead_parts + (None,) * 2
    if shd.model_sharded(lead_parts):
        return (*none, nnz, "experts")
    mat = tuple(waxes[len(lead):])
    if mat and not any("model" in shd.DEFAULT_RULES.get(a, ())
                       for a in mat if a is not None):
        return (*none, nnz, None)
    kind, nnz = _packed_layout(path, nb, nnz,
                               shd.axis_sizes(mesh).get("model", 1))
    if kind == "nnz":
        return (lead_parts + (None, "model", None, None),
                lead_parts + (None, "model"), nnz, kind)
    if kind == "nb":
        return (lead_parts + ("model", None, None, None),
                lead_parts + ("model", None), nnz, kind)
    return (*none, nnz, None)


def abstract_packed_params(cfg, sparsity: float, mesh=None):
    """Serving params with every sparse leaf replaced by an abstract
    ``PackedBCSC`` at ``sparsity`` (``models.params.AbstractParam``
    leaves, bf16 where the model is f32), and with ``mesh`` their specs
    (``PackedBCSC`` of specs at the packed paths). Returns
    (abstract params, specs or None)."""
    from repro_torch.models import registry
    from repro_torch.models.params import AbstractParam

    def bf16(t):
        if isinstance(t, dict):
            return {k: bf16(v) for k, v in t.items()}
        return AbstractParam(t.shape, torch.bfloat16
                             if t.dtype == torch.float32 else t.dtype)

    abs_p = bf16(registry.abstract_params(cfg))
    specs = (shd.param_specs_tree(registry.param_specs(cfg), mesh)
             if mesh is not None else None)
    axes = registry.axes_tree(cfg)
    for path in registry.sparse_paths(cfg):
        w = sm.get_path(abs_p, path)
        bi, bo = sm.block_dims_for(cfg.blast, path)
        kb, nb = w.shape[-2] // bi, w.shape[-1] // bo
        nnz = max(1, math.ceil((1.0 - sparsity) * kb))
        lead = tuple(w.shape[:-2])
        if mesh is not None:
            bspec, ispec, nnz, _ = _packed_specs(
                path, lead, sm.get_path(axes, path), nb, nnz, mesh)
            specs = sm.set_path(specs, path,
                                packing.PackedBCSC(bspec, ispec, kb))
        abs_p = sm.set_path(abs_p, path, packing.PackedBCSC(
            blocks=AbstractParam(lead + (nb, nnz, bi, bo), torch.bfloat16),
            idx=AbstractParam(lead + (nb, nnz), torch.int32), kb=kb))
    return abs_p, specs


def shard_pack(p: packing.PackedBCSC, path: str, mesh,
               lead_axes: tuple = ()) -> packing.PackedBCSC:
    """One rank's share of the pack at ``path`` on ``mesh`` (the layout
    above; ``lead_axes`` the logical axes of the weight, e.g.
    ``("layers", "experts", "embed", "ff")``; leading dims without one
    stay whole): ``partial`` set where the nnz dim splits. An expert
    pack keeps its experts' slice, unpadded."""
    lead = tuple(p.idx.shape[:-2])
    waxes = tuple(lead_axes) + (None,) * (len(lead) - len(lead_axes))
    bspec, ispec, nnz, kind = _packed_specs(path, lead, waxes, p.nb, p.nnz,
                                            mesh)
    if kind == "nnz":
        p = packing.pad_nnz(p, nnz)     # swapped leaves only: no joint
    tp = shd.axis_sizes(mesh).get("model", 1)
    return dataclasses.replace(p, blocks=shd.shard(p.blocks, bspec, mesh),
                               idx=shd.shard(p.idx, ispec, mesh),
                               partial=kind == "nnz" and tp > 1)


def shard_params(cfg, params, mesh, rules: dict | None = None):
    """One rank's shard of a serving tree (packed, pruned-dense or
    full) on ``mesh`` (a ``distributed.context.Mesh``): each pack split
    by the layout above (``shard_pack``), every other leaf by
    ``sharding.spec_for`` over its logical axes, except that the
    two-matrix MLP's ``b_in`` splits exactly where its packed ``w_in``'s
    block-columns do (whole where they do not split). Split leaves are
    copies, so the full tree can be freed; replicated ones are the given
    tensors."""
    from repro_torch.models import registry
    specs = shd.param_specs_tree(registry.param_specs(cfg), mesh, rules)
    axes = registry.axes_tree(cfg)

    def walk(node, spec, path):
        if isinstance(node, dict):
            out = {k: walk(v, spec[k], f"{path}/{k}" if path else k)
                   for k, v in node.items()}
            w = node.get("w_in")
            if isinstance(w, packing.PackedBCSC) and "b_in" in node \
                    and out["w_in"].nb == w.nb:
                out["b_in"] = node["b_in"]     # w_in's columns stay whole
            return out
        if isinstance(node, packing.PackedBCSC):
            return shard_pack(node, path, mesh, sm.get_path(axes, path))
        return shd.shard(node, spec, mesh)
    return walk(params, specs, "")
