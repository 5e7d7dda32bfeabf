"""Export pruned weights for serving (port of ``repro/serving/export.py``):

  * ``prune_params`` — bake masks into the weights (zeros in pruned
    blocks) and cast f32 leaves to bf16: the dense serving layout;
  * ``pack_params``  — replace every sparse weight with its balanced-BCSC
    ``PackedBCSC``, marking gate/up pairs with one idx table ``joint``;
    layer-stacked leaves pack per layer in one pass, and a 2-D leaf (zamba's
    one shared MLP) packs as a single matrix;
  * ``memory_report`` — bytes of the serving weights.

Every function walks the tree by its sparse paths and dicts alone, so
whisper's nested stacks (``encoder/mlp/w_in`` ... ``decoder/mlp/w_out``)
take the same walk as a transformer's ``layers``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core import packing, sparse_mlp as sm, topk


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
