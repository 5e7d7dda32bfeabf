"""Sparsity schedule (port of ``repro/core/schedule.py``).

``s_i = s_max + (s_init - s_max) * (1 - i / (m - d))^3``; host-side
scalars here, since the port evaluates the schedule outside any trace.

The reference evaluates the schedule inside the jitted train step on a
traced step, where XLA rewrites the division by the constant horizon as
a multiplication by its float32 reciprocal, the cube as ``(t * t) * t``
and the last multiply-add as one fused operation. ``sparsity_at``
rounds the same way, so the keep counts (and with them the masks) match
the reference's bitwise at every step; a plain float32 ``t ** 3 / h``
differs in the last bit at about a third of the steps.
"""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def fma32(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return _F(np.float64(_F(a)) * np.float64(_F(b)) + np.float64(_F(c)))


def step_fraction(step, horizon: int) -> np.float32:
    """``clip(step / horizon, 0, 1)`` in float32, the division done as a
    multiplication by the float32 reciprocal."""
    frac = _F(step) * (_F(1.0) / _F(max(int(horizon), 1)))
    return _F(min(max(frac, _F(0.0)), _F(1.0)))


def sparsity_at(step, *, s_init: float, s_max: float, total_steps: int,
                decay: int = 0) -> float:
    """Scheduled sparsity at ``step``, as a float32 value in
    [s_init, s_max]."""
    t = _F(1.0) - step_fraction(step, int(total_steps) - int(decay))
    return float(fma32((t * t) * t, s_init - s_max, s_max))


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


def is_refresh_step(step, step_size: int) -> bool:
    """True when the prune-grow mask refresh fires at ``step`` (the
    cadence of ``sparse_mlp.maybe_refresh``)."""
    return step_size > 0 and int(step) % int(step_size) == 0


def steps_since_refresh(step, step_size: int) -> int:
    """Steps elapsed since the most recent scheduled mask refresh at or
    before ``step`` (0 on a refresh step itself). With no refresh
    cadence (``step_size <= 0``) returns ``step``."""
    if step_size <= 0:
        return int(step)
    return int(step) % int(step_size)
