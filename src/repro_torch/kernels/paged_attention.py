"""Paged-KV decode attention: the hand-written CUDA flash-decode kernel
(``csrc/paged_attention.cu``), its plain PyTorch version and the
attention adapter (port of ``repro/kernels/paged_attention.py``).

``paged_flash_decode`` launches the kernel for CUDA tensors and runs
``paged_flash_decode_plain`` for CPU tensors. Both fold each lane's
pages, picked through its block table, into an f32 online softmax; the
plain version walks the pages in a Python loop (``fold_pages``). The
kernel splits the page axis into S contiguous chunks, one CTA each
(``split_plan.decode_splits``), and merges their (m, l, acc) partials.
Masking (causal, window, ragged left-pad) arrives as an additive
0 / -1e30 bias row per (lane, slot), built by ``mask_bias``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, split_plan
from repro_torch.kernels.bspmm import DTYPE_CODES, device_index, n_sms

NEG_INF = -1e30

LAUNCHES = {"paged_flash_decode": 0}
# what the kernel holds in registers: hd <= 256 at G <= 8 query heads per
# kv head, hd <= 128 at G <= 16 (two row groups of 8)
MAX_G, MAX_HD, MAX_HD_G16 = 16, 256, 128

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    f = build.library("paged_attention.cu").paged_flash_decode_launch
    f.argtypes = ([_P, _P, _P, _P, _I, _P, _P] + [_I] * 7
                  + [ctypes.c_float, ctypes.c_float] + [_I] * 4 + [_P])
    f.restype = ctypes.c_int
    return f


def fold_pages(q4, pool_k, pool_v, block_tables, bias, pages, *,
               scale: float, softcap: float = 0.0):
    """The online softmax of every (lane, kv head) over the table columns
    ``pages`` (a range), in order: (m, l, acc) of shapes (B, KV, G, 1)
    twice and (B, KV, G, hd), f32. A range with no valid slot leaves
    (-1e30, 0, 0)."""
    b, kvh, g, hd = q4.shape
    ps = pool_k.shape[1]
    qf = q4.float()
    m = torch.full((b, kvh, g, 1), NEG_INF, dtype=torch.float32,
                   device=q4.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, hd), dtype=torch.float32, device=q4.device)
    for j in pages:
        idx = block_tables[:, j].long()
        k = pool_k[idx].permute(0, 2, 1, 3).float()        # (B, KV, ps, hd)
        v = pool_v[idx].permute(0, 2, 1, 3).float()
        s = torch.einsum("bhgd,bhsd->bhgs", qf, k) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        valid = (bias[:, j * ps:(j + 1) * ps] > NEG_INF / 2)[:, None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgs,bhsd->bhgd", p.to(q4.dtype).float(), v)
        m = m_new
    return m, l, acc


def paged_flash_decode_plain(q4, pool_k, pool_v, block_tables, bias, *,
                             scale: float, softcap: float = 0.0):
    """q4 (B, KV, G, hd); pool_k/v (n_pages, ps, KV, hd); block_tables
    (B, R) int32; bias (B, R*ps) f32 -> (B, KV, G, hd) f32."""
    _, l, acc = fold_pages(q4, pool_k, pool_v, block_tables, bias,
                           range(block_tables.shape[1]), scale=scale,
                           softcap=softcap)
    return acc / l.clamp_min(1e-30)


def _check(q4, pool_k, pool_v, block_tables, bias) -> None:
    for name, t in (("q4", q4), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_tables", block_tables), ("bias", bias)):
        if t.device != q4.device:
            raise ValueError(f"{name} on {t.device}, q4 on {q4.device}")
    if q4.dim() != 4 or not q4.is_contiguous():
        raise ValueError("q4 must be a contiguous (B, KV, G, hd) tensor")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4:
        raise ValueError("pool_k/pool_v must be (n_pages, ps, KV, hd)")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pool pages must be contiguous")
    b, kvh, g, hd = q4.shape
    if pool_k.shape[2] != kvh or pool_k.shape[3] != hd:
        raise ValueError(f"pool {tuple(pool_k.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    if g > MAX_G or hd > MAX_HD or (g > 8 and hd > MAX_HD_G16):
        raise ValueError(f"the kernel takes G <= {MAX_G} query heads per "
                         f"kv head and hd <= {MAX_HD} (hd <= {MAX_HD_G16} "
                         f"at G > 8), got G={g}, hd={hd}")
    if q4.dtype not in DTYPE_CODES or pool_k.dtype != pool_v.dtype or not (
            pool_k.dtype == q4.dtype or (q4.dtype == torch.float32
                                         and pool_k.dtype == torch.bfloat16)):
        raise TypeError(f"q {q4.dtype} over pool {pool_k.dtype} not "
                        "supported")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.stride(1) != 1):
        raise ValueError("block_tables must be (B, R) int32 with unit "
                         "column stride")
    r, ps = block_tables.shape[1], pool_k.shape[1]
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (b, r * ps)
            or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous f32 (B, R*ps) = "
                         f"{(b, r * ps)}, got {tuple(bias.shape)}")


def paged_flash_decode(q4, pool_k, pool_v, block_tables, bias, *,
                       scale: float, softcap: float = 0.0) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones.
    Same arguments and result as ``paged_flash_decode_plain``."""
    if q4.device.type == "cpu":
        return paged_flash_decode_plain(q4, pool_k, pool_v, block_tables,
                                        bias, scale=scale, softcap=softcap)
    if q4.device.type != "cuda":
        raise ValueError(f"no paged decode for device {q4.device}")
    _check(q4, pool_k, pool_v, block_tables, bias)
    b, kvh, g, hd = q4.shape
    n_pages, ps = pool_k.shape[:2]
    r = block_tables.shape[1]
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q4.device)
    dev = device_index(q4)
    rc = _fn()(q4.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               block_tables.data_ptr(), block_tables.stride(0),
               bias.data_ptr(), out.data_ptr(), b, kvh, g, hd, ps, r,
               n_pages, float(scale), float(softcap),
               split_plan.decode_splits(b, kvh, r, n_sms(dev)),
               DTYPE_CODES[q4.dtype], DTYPE_CODES[pool_k.dtype], dev,
               torch.cuda.current_stream(q4.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["paged_flash_decode"] += 1
    return out


def mask_bias(posb: torch.Tensor, kpos: torch.Tensor,
              window: int = 0) -> torch.Tensor:
    """(B,1) query positions + (B,S) slot positions -> (B,S) additive
    bias: 0 where the causal (and optional window) mask admits the slot,
    NEG_INF elsewhere."""
    mask = posb >= kpos
    if window:
        mask &= posb - kpos < window
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def paged_decode_attn(cfg, q, pool_k, pool_v, block_tables, posb, kpos, *,
                      window: int = 0) -> torch.Tensor:
    """models/attention.py adapter: q (B,1,H,hd) -> out (B,1,H,hd) in q's
    dtype; ``block_tables`` (B, R) is each lane's first R logical pages."""
    b, _, h, hd = q.shape
    kvh = pool_k.shape[2]
    scale = cfg.attn_scale or 1.0 / math.sqrt(hd)
    q4 = q.reshape(b, kvh, h // kvh, hd).contiguous()
    bias = mask_bias(posb, kpos, window)
    out = paged_flash_decode(
        q4, pool_k, pool_v, block_tables, bias, scale=scale,
        softcap=float(cfg.attn_logit_softcap or 0.0))
    return out.reshape(b, 1, h, hd).to(q.dtype)
