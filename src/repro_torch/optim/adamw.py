"""AdamW (port of ``repro/optim/adamw.py``), sparse-aware:

  * global-norm gradient clipping;
  * decoupled weight decay (skipped for 1-D params: norms, biases);
  * BLaST: the caller masks the gradients, and ``mask_moments`` zeroes
    the first and second moments of every pruned block (RigL semantics),
    so a freshly pruned block's momentum cannot push its zeroed weight
    off zero.

Trees are nested dicts of tensors, walked in sorted-key order (the
reference's pytree order). ``update`` returns new tensors and leaves its
inputs unchanged, like the reference; the trainer decides skip or
update before calling it. Scalars of the schedule are host float32
values rounded as the reference's jitted step rounds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.schedule import fma32, step_fraction

_F = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(c: AdamWConfig, step) -> float:
    """Linear warmup, then cosine decay to ``end_lr_frac * peak``.
    Rounded as the reference's jitted step rounds it: the warmup slope
    is folded into one float32 constant, peak * (1 / warmup)."""
    if step < c.warmup_steps:
        return float(_F(step) * (_F(c.peak_lr) *
                                 (_F(1.0) / _F(max(c.warmup_steps, 1)))))
    frac = step_fraction(_F(step) - _F(c.warmup_steps),
                         c.total_steps - c.warmup_steps)
    cos = np.cos(_F(np.pi) * frac, dtype=_F)
    return float(_F(c.peak_lr) * fma32((1 - c.end_lr_frac) * 0.5,
                                        _F(1.0) + cos, c.end_lr_frac))


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init(params) -> dict:
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a device
    scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def update(c: AdamWConfig, grads, opt_state, params, step: int):
    """One AdamW step. Returns (new_params, new_opt_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
    lr = lr_at(c, step)
    t = _F(step) + _F(1.0)
    bc1 = float(_F(1.0) - _F(c.b1) ** t)
    bc2 = float(_F(1.0) - _F(c.b2) ** t)

    def upd(p, g, m, v):
        g = g.float()
        m = c.b1 * m + (1 - c.b1) * g
        v = c.b2 * v + (1 - c.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
        if p.dim() >= 2:   # decoupled weight decay, matrices only
            delta = delta + c.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return (_unzip(out, 0), {"m": _unzip(out, 1), "v": _unzip(out, 2)},
            {"grad_norm": gnorm, "lr": lr})


def _unzip(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]


def mask_moments(opt_state, masks: dict, spec):
    """Zero the Adam moments of every PRUNED block. Grown blocks were
    pruned before, so their moments are zero already."""
    from repro_torch.core import sparse_mlp as sm, topk
    new = dict(opt_state)
    for which in ("m", "v"):
        tree = new[which]
        for path, mask in masks.items():
            bi, bo = sm.block_dims_for(spec, path)
            tree = sm.set_path(tree, path, topk.apply_block_mask(
                sm.get_path(tree, path), mask, bi, bo))
        new[which] = tree
    return new
