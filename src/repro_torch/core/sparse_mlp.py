"""Block-sparse MLP forward (port of the forward half of
``repro/core/sparse_mlp.py``): activations, the GLU and two-matrix MLPs
with dense or packed weights, and param-tree path helpers.

Packed weights (``PackedBCSC``) go through ``kernels/ops.py``: one fused
GLU kernel and one BSpMM. The training half (STE masks, prune-and-grow
refresh) belongs to the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PackedBCSC
from repro_torch.core.prune_grow import BlastSpec

Params = dict

# BlastSpec.b_in tiles the d_model side and b_out the d_ff side of EVERY
# matrix: up-projections (D, F) use (b_in, b_out), down-projections (F, D)
# the swapped (b_out, b_in). The orientation follows the leaf name.
_SWAPPED_LEAVES = ("w_down", "w_out", "ws_down")


def block_dims_for(spec: BlastSpec, path: str) -> tuple[int, int]:
    leaf = path.split("/")[-1]
    if leaf in _SWAPPED_LEAVES:
        return spec.b_out, spec.b_in
    return spec.b_in, spec.b_out


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def glu_mlp(x, w_gate, w_up, w_down, *, act="silu"):
    """(act(x W_g) * (x W_u)) W_d — paper Eq. (1) for silu. Packed
    weights dispatch to the fused BSpMM path over (M, d) rows."""
    if isinstance(w_gate, PackedBCSC):
        from repro_torch.kernels import ops
        y = ops.sparse_mlp_apply(_flat(x), w_gate, w_up, w_down, act=act)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    dt = x.dtype
    h = act_fn(act)(x @ w_gate.to(dt)) * (x @ w_up.to(dt))
    return h @ w_down.to(dt)


def mlp2(x, w_in, w_out, b_in_=None, b_out_=None, *, act="gelu",
         square: bool = False):
    """Two-matrix MLP (GPT-2): act(x W1 + b1) W2 + b2; ``square`` squares
    the activation."""
    dt = x.dtype
    packed = isinstance(w_in, PackedBCSC)
    if packed:
        from repro_torch.kernels import ops
        h = ops.bspmm(_flat(x), w_in)
    else:
        h = x @ w_in.to(dt)
    if b_in_ is not None:
        h = h + b_in_.to(h.dtype)
    h = act_fn(act)(h)
    if square:
        h = h * h
    y = ops.bspmm(h, w_out) if packed else h @ w_out.to(dt)
    if b_out_ is not None:
        y = y + b_out_.to(y.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def get_path(tree: Params, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def set_path(tree: Params, path: str, value) -> Params:
    """Functional set (copies the dicts along the path)."""
    keys = path.split("/")

    def rec(node, i):
        node = dict(node)
        node[keys[i]] = value if i == len(keys) - 1 else rec(node[keys[i]],
                                                               i + 1)
        return node
    return rec(tree, 0)
