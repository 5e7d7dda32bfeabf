"""Block-granularity scoring and top-k mask selection (port of
``repro/core/topk.py``).

A weight ``W`` (K, N) is a grid of ``(K/b_in) x (N/b_out)`` blocks scored
by Frobenius norm. ``balanced`` selection keeps the same number of
blocks in every block-column (static-shape packing); ``global`` keeps
the top-k over the whole grid. Masks are bitwise-equal to the
reference's except at exact score ties between blocks, which both sides
break by index but whose f32 norms may round differently.
"""
from __future__ import annotations

import torch


def block_norms(w: torch.Tensor, b_in: int, b_out: int) -> torch.Tensor:
    """Frobenius norm of each (b_in, b_out) block, summed in float32.

    w: (..., K, N) -> (..., K//b_in, N//b_out) float32."""
    *lead, k, n = w.shape
    if k % b_in or n % b_out:
        raise ValueError(f"block ({b_in},{b_out}) does not tile weight "
                         f"{(k, n)}")
    kb, nb = k // b_in, n // b_out
    w2 = (w.float() ** 2).reshape(*lead, kb, b_in, nb, b_out)
    return torch.sqrt(w2.sum(dim=(-3, -1)))


def _ranks_desc(s: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of s[i] in a descending sort of the last axis,
    ties broken by index (stable)."""
    order = torch.argsort(-s, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


def topk_mask_global(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the ``k`` largest entries over the last TWO axes."""
    *lead, kb, nb = scores.shape
    ranks = _ranks_desc(scores.reshape(*lead, kb * nb))
    return (ranks < k).reshape(scores.shape)


def topk_mask_per_col(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the ``k`` largest entries of every block-column.
    scores: (..., Kb, Nb)."""
    mask = _ranks_desc(scores.transpose(-2, -1)) < k
    return mask.transpose(-1, -2)


def expand_mask(block_mask: torch.Tensor, b_in: int,
                b_out: int) -> torch.Tensor:
    """(..., Kb, Nb) bool -> (..., Kb*b_in, Nb*b_out) elementwise mask."""
    m = torch.repeat_interleave(block_mask, b_in, dim=-2)
    return torch.repeat_interleave(m, b_out, dim=-1)


def apply_block_mask(w: torch.Tensor, block_mask: torch.Tensor,
                     b_in: int, b_out: int) -> torch.Tensor:
    """Zero out pruned blocks of ``w`` (mask may have leading dims)."""
    return w * expand_mask(block_mask, b_in, b_out).to(w.dtype)


def mask_sparsity(block_mask: torch.Tensor) -> torch.Tensor:
    """Fraction of pruned blocks (f32 scalar)."""
    return 1.0 - block_mask.float().mean()
