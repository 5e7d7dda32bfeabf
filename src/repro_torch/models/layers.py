"""Shared building blocks: norms, rotary embeddings, softcap and the
rematerialisation policy (port of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm scaling by ``1 + weight`` (zero-initialised weights)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm(kind: str, x, weight, bias=None):
    if kind == "rmsnorm":
        return rmsnorm(x, weight)
    return layernorm(x, weight, bias)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy (which would wait for
    # the stream) on the decode path
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Half-split convention,
    computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# the matmul ops a policy may keep: with and without batch dims
_DOTS_NO_BATCH = ("mm", "addmm")
_DOTS = _DOTS_NO_BATCH + ("bmm", "baddbmm")


def remat_policy(cfg):
    """The ``context_fn`` for ``torch.utils.checkpoint.checkpoint`` that
    keeps what ``cfg.remat_policy`` names (the reference's JAX policy of
    the same name), or None for ``nothing_saveable`` (every activation
    recomputed). ``dots_saveable`` keeps every matmul's output,
    ``dots_with_no_batch_dims_saveable`` those of the 2-D products (the
    projections, not attention's batched ones). Memory, not numbers:
    the recomputed ops run the same kernels on the same inputs."""
    saved = {"nothing_saveable": None, "dots_saveable": _DOTS,
             "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH
             }[cfg.remat_policy]
    if saved is None:
        return None
    import functools

    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    ops = [getattr(torch.ops.aten, name).default for name in saved]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)
