"""Blocked prune-and-grow (port of ``repro/core/prune_grow.py``).

Per sparse weight W with dense gradient G, at every mask refresh: score
each (b_in, b_out) block by its Frobenius norm in W and in G; keep the
top ``kept - grow`` blocks by |W|; grow ``grow`` more by |G| among the
blocks not kept (the fixed-budget RigL difference step); zero the newly
grown blocks. ``grow_frac`` cosine-decays to ``grow_frac_end``. The step
is a host int here, so budgets are host ints and selection is the
stable-rank rule of ``core/topk.py`` (masks match the reference's
bitwise).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import topk
from repro_torch.core.schedule import (fma32, keep_count, sparsity_at,
                                       step_fraction)


@dataclasses.dataclass(frozen=True)
class BlastSpec:
    """Static sparsification hyper-parameters for one model (paper Table 2)."""
    enabled: bool = True
    b_in: int = 128            # block rows (K / d_model side)
    b_out: int = 128           # block cols (N / d_ff side) == paper's b
    s_init: float = 0.0
    s_max: float = 0.8
    step_size: int = 100       # mask refresh interval (paper §5.4.2)
    decay: int = 0             # d in Eq. 2 (paper §5.4.3)
    total_steps: int = 10_000  # m in Eq. 2
    dense_last: int = 2        # L rightmost MLP blocks stay dense (§5.4.4)
    selection: Literal["balanced", "global"] = "balanced"
    grow_frac: float = 0.3     # fraction of kept budget regrown by |G|
    grow_frac_end: float = 0.0 # cosine-decayed to this by total_steps


def grow_count(spec: BlastSpec, step, kept: int) -> int:
    """Number of blocks regrown by gradient at this refresh (cosine decay
    of ``grow_frac``, float32 as in the reference), at most ``kept - 1``
    so at least one block is chosen by |W|."""
    frac = step_fraction(step, spec.total_steps)
    cos = np.cos(np.float32(np.pi) * frac, dtype=np.float32)
    g = fma32(0.5 * (spec.grow_frac - spec.grow_frac_end),
              np.float32(1.0) + cos, spec.grow_frac_end)
    return min(int(g * np.float32(kept)), max(kept - 1, 0))


def _select(spec: BlastSpec, scores: torch.Tensor, k: int) -> torch.Tensor:
    if spec.selection == "balanced":
        return topk.topk_mask_per_col(scores, k)
    return topk.topk_mask_global(scores, k * scores.shape[-1])


def generate_mask(spec: BlastSpec, w: torch.Tensor, g: torch.Tensor,
                  step: int) -> torch.Tensor:
    """One prune-and-grow mask refresh for one weight: bool block mask of
    shape (..., Kb, Nb); leading dims (layers, experts) select
    independently. ``balanced`` budgets are per block-column, ``global``
    ones are scaled by Nb."""
    wn = topk.block_norms(w, spec.b_in, spec.b_out)
    gn = topk.block_norms(g, spec.b_in, spec.b_out)
    s = sparsity_at(step, s_init=spec.s_init, s_max=spec.s_max,
                    total_steps=spec.total_steps, decay=spec.decay)
    kept = keep_count(s, wn.shape[-2])                 # per-column budget
    grow = grow_count(spec, step, kept)
    keep_mask = _select(spec, wn, kept - grow)
    # difference step: gradient-selected blocks not already kept
    grow_mask = _select(spec, gn.masked_fill(keep_mask, -torch.inf), grow)
    return keep_mask | grow_mask


def prune_weight(spec: BlastSpec, w: torch.Tensor,
                 block_mask: torch.Tensor) -> torch.Tensor:
    """Zero out pruned blocks."""
    return topk.apply_block_mask(w, block_mask, spec.b_in, spec.b_out)


def refresh_mask_and_weight(spec: BlastSpec, w: torch.Tensor,
                            g: torch.Tensor, old_mask: torch.Tensor,
                            step: int):
    """Full refresh: (new mask, pruned weight, newly grown blocks). The
    grown blocks' weights are zeroed; they were pruned, hence zero,
    already, but the paper sets them to zero explicitly."""
    new_mask = generate_mask(spec, w, g, step)
    grown = new_mask & ~old_mask
    return new_mask, zero_grown(spec, prune_weight(spec, w, new_mask),
                                grown), grown


def zero_grown(spec: BlastSpec, w: torch.Tensor,
               grown: torch.Tensor) -> torch.Tensor:
    return torch.where(topk.expand_mask(grown, spec.b_in, spec.b_out),
                       0.0, w).to(w.dtype)


def initial_mask(spec: BlastSpec, w: torch.Tensor) -> torch.Tensor:
    """All-ones mask at s_init=0, else the top blocks by |W| at s_init.
    Leading dims of ``w`` (layers, experts) select independently."""
    kb, nb = w.shape[-2] // spec.b_in, w.shape[-1] // spec.b_out
    lead = tuple(w.shape[:-2])
    if spec.s_init <= 0.0:
        return torch.ones(lead + (kb, nb), dtype=torch.bool, device=w.device)
    wn = topk.block_norms(w, spec.b_in, spec.b_out)
    return _select(spec, wn, keep_count(spec.s_init, kb))
