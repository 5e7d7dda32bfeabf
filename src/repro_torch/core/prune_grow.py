"""One-shot block magnitude pruning (port of ``repro/core/prune_grow.py``,
mask side only: ``BlastSpec``, ``initial_mask``, ``prune_weight``).

The gradient-driven grow step (``generate_mask``, ``refresh_*``) belongs
to the training slice and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import topk
from repro_torch.core.schedule import keep_count


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


def _select(spec: BlastSpec, scores: torch.Tensor, k: int) -> torch.Tensor:
    if spec.selection == "balanced":
        return topk.topk_mask_per_col(scores, k)
    return topk.topk_mask_global(scores, k * scores.shape[-1])


def prune_weight(spec: BlastSpec, w: torch.Tensor,
                 block_mask: torch.Tensor) -> torch.Tensor:
    """Zero out pruned blocks."""
    return topk.apply_block_mask(w, block_mask, spec.b_in, spec.b_out)


def initial_mask(spec: BlastSpec, w: torch.Tensor) -> torch.Tensor:
    """All-ones mask at s_init=0, else the top blocks by |W| at s_init.
    Leading dims of ``w`` (layers, experts) select independently."""
    kb, nb = w.shape[-2] // spec.b_in, w.shape[-1] // spec.b_out
    lead = tuple(w.shape[:-2])
    if spec.s_init <= 0.0:
        return torch.ones(lead + (kb, nb), dtype=torch.bool, device=w.device)
    wn = topk.block_norms(w, spec.b_in, spec.b_out)
    return _select(spec, wn, keep_count(spec.s_init, kb))
