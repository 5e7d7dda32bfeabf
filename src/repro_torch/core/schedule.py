"""Sparsity schedule (port of ``repro/core/schedule.py``).

``s_i = s_max + (s_init - s_max) * (1 - i / (m - d))^3``; host-side
scalars here, since the port evaluates the schedule outside any trace.
"""
from __future__ import annotations

import math

import numpy as np


def sparsity_at(step, *, s_init: float, s_max: float, total_steps: int,
                decay: int = 0) -> float:
    """Scheduled sparsity at ``step``, as a float32 value in
    [s_init, s_max]."""
    horizon = max(int(total_steps) - int(decay), 1)
    frac = np.clip(np.float32(step) / np.float32(horizon), 0.0, 1.0)
    s = s_max + (s_init - s_max) * (1.0 - frac) ** 3
    return float(np.float32(s))


def keep_count(sparsity, n_blocks: int, minimum: int = 1) -> int:
    """Number of blocks to KEEP at ``sparsity`` out of ``n_blocks``:
    ceil((1 - s) * n), clamped to [minimum, n_blocks].

    Computed in float32 like the reference (``1 - s`` and the product
    round to float32). The two precisions disagree at boundaries: at
    s=0.9 and n=10 float32 gives ceil(1.0000002)=2 where float64 gives
    ceil(0.9999999999999998)=1."""
    s = np.float32(sparsity)
    kept = math.ceil(float((np.float32(1.0) - s) * np.float32(n_blocks)))
    return int(min(max(kept, minimum), n_blocks))
