"""Parameter declaration and seeded initialisation (port of
``repro/models/params.py``).

A ``ParamSpec`` tree is the one source of truth for each leaf's shape,
dtype and init; ``init_params`` materialises it with a
``torch.Generator`` on the requested device. The numbers differ from
``jax.random``'s for the same seed: parity tests share weights through
``interop``, not seeds.

One deliberate difference in the distribution: the reference scales a
normal leaf by the size of its second-to-last axis, which for the 3-D
attention weights is a head axis (``wq`` (d, H, hd) gets 1/sqrt(H),
``wk``/``wv`` 1/sqrt(KV), ``wo`` (H, hd, d) 1/sqrt(hd)), 8-16x the
1/sqrt(fan-in) of the product it computes. At Llama-3.2-1B's depth
that makes the seeded random network's attention so sharp that its
gradient norm grows by orders of magnitude with depth and training
does not lower the loss. ``ParamSpec.fan_in`` names the true fan-in
where the shape does not show it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    init: str = "normal"                  # normal|zeros|ones|embed
    scale: float = 1.0                    # fan-in scaling multiplier
    dtype: str = "float32"
    fan_in: int = 0                       # 0: the second-to-last axis

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               device) -> torch.Tensor:
    dt = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "embed":
        std = 0.02 * spec.scale
    else:
        # fan-in scaled normal (last-but-one dim is fan-in for matrices)
        fan_in = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                 else spec.shape[-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w.mul_(std)).to(dt)


def _leaves(specs: dict, prefix: str = ""):
    """(path, spec) pairs in sorted-key order (the reference's pytree
    flattening order)."""
    for k in sorted(specs):
        v = specs[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + "/")
        else:
            yield path, v


def init_params(specs: dict, seed: int = 0, device="cuda") -> dict:
    """Materialise a nested ParamSpec tree on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = _init_leaf(gen, spec, device)
    return out
