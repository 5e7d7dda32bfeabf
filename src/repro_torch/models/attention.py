"""GQA attention (port of ``repro/models/attention.py``): the
full-sequence causal or windowed attention of training, and attention
over the paged KV pool for serving.

The pool ``(n_pages, page_size, KV, hd)`` is shared by every lane; lane
b's logical cache slot ``s`` lives at pool page ``block_tables[b, s //
page_size]``, row ``s % page_size``. Slot numbering, rope positions and
masking (``_cache_positions``) are the reference's. Decode attention
goes through the hand-written flash-decode kernel
(``kernels/paged_attention.py``); prefill attention stays plain torch
(gather + softmax), as the reference leaves it to XLA.

Unlike the reference, ``paged_write`` updates the pool IN PLACE, which
saves one pool copy per layer per step; the functions that call it
return the same tensors they were given.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, rmsnorm, softcap
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30

# Cache slots holding no real token (left-padding of ragged prompts) get
# this sentinel logical position: larger than any query position, so the
# causal mask excludes them.
_PAD_POS = 1 << 30


def eff_heads(cfg) -> tuple[int, int]:
    """(q_heads, kv_heads) after TP padding."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if cfg.pad_heads_to:
        h = max(h, cfg.pad_heads_to)
        if cfg.num_kv_heads == cfg.num_heads:     # MHA: pad kv too
            kv = h
    return h, kv


def attn_param_specs(cfg) -> dict:
    """ParamSpec dict for one attention block (stacked by the caller)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = eff_heads(cfg)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"),
                        fan_in=d),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        fan_in=d),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        fan_in=d),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        scale=1.0 / math.sqrt(2 * cfg.num_layers),
                        fan_in=h * hd),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
    return specs


def _project_qkv(cfg, p, x):
    """-> q (B,S,H,hd), k, v (B,S,KV,hd)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def _out_proj(p, out):
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def _scores_to_out(cfg, q, k, v, q_pos, k_pos, causal, window):
    """Grouped attention core. q (B,Sq,H,hd); k/v (B,Sk,KV,hd); q_pos
    (B,Sq); k_pos (B,Sk). Scores and the PV product accumulate in f32;
    probabilities are rounded to v's dtype first, as the reference does.
    Returns (B,Sq,H,hd) in q's dtype."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = cfg.attn_scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float()) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos[:, None, :]
    if window:
        mask &= q_pos[:, :, None] - k_pos[:, None, :] < window
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def multihead_attention(cfg, p, x, positions, *, causal=True, window=0,
                        q_chunk=1024):
    """Full-sequence (training) self-attention. x (B,S,D); positions
    (B,S). Queries run in chunks of ``q_chunk`` when S is a multiple of
    it, which bounds the score transient to (q_chunk, S).

    Returns (out (B,S,D), (k, v))."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s = q.shape[1]
    if s <= q_chunk or s % q_chunk:
        out = _scores_to_out(cfg, q, k, v, positions, positions, causal,
                             window)
    else:
        out = torch.cat([
            _scores_to_out(cfg, q[:, i:i + q_chunk], k, v,
                           positions[:, i:i + q_chunk], positions, causal,
                           window) for i in range(0, s, q_chunk)], dim=1)
    return _out_proj(p, out), (k, v)


def _cache_positions(smax: int, offsets: torch.Tensor) -> torch.Tensor:
    """(B, Smax) logical position of each cache slot for right-aligned
    sequences: slot s holds logical token ``s - offset``; slots before
    ``offset`` are padding (``_PAD_POS``, always masked)."""
    slots = torch.arange(smax, dtype=torch.int32,
                         device=offsets.device)[None, :]
    off = offsets.to(torch.int32)[:, None]
    return torch.where(slots >= off, slots - off, _PAD_POS)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor,
                 read_pages: int) -> torch.Tensor:
    """(n_pages, ps, KV, hd) pool + (B, max_pages) tables ->
    (B, read_pages*ps, KV, hd): each lane's first ``read_pages`` logical
    pages, in logical-slot order."""
    b = block_tables.shape[0]
    g = pool[block_tables[:, :read_pages].long()]     # (B, R, ps, KV, hd)
    return g.reshape(b, read_pages * pool.shape[1], *pool.shape[2:])


def paged_write(pool: torch.Tensor, block_tables: torch.Tensor,
                slots: torch.Tensor, values: torch.Tensor,
                lane_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``values`` at logical ``slots`` through the block tables, IN
    PLACE, and return ``pool``.

    pool: (n_pages, ps, KV, hd); slots: (B,) or (B, C); values:
    slots.shape + (KV, hd). Slots past the table end (>= max_pages*ps,
    where the engine parks finished lanes) and lanes masked out by
    ``lane_mask`` ((B,) or (B, C) bool) are DROPPED, never clamped: a
    clamp would land the write on pool page 0, which may belong to
    another lane.

    The drop needs no host sync: every dropped entry is redirected to
    the target of the first kept entry, carrying that entry's value, so
    the one location written twice receives the same bytes from every
    writer whatever the order. When nothing is kept, all entries rewrite
    one location with its own current value."""
    n_pages, ps = pool.shape[0], pool.shape[1]
    max_pages = block_tables.shape[1]
    s2 = slots.to(torch.int64)
    if s2.dim() == 1:
        s2 = s2[:, None]
        values = values[:, None]
    page = torch.div(s2, ps, rounding_mode="floor")
    ok = page < max_pages
    if lane_mask is not None:
        ok &= lane_mask[:, None] if lane_mask.dim() == 1 else lane_mask
    phys = torch.gather(block_tables.to(torch.int64), 1,
                        page.clamp(max=max_pages - 1))
    flat = pool.view(n_pages * ps, *pool.shape[2:])
    tgt = (phys * ps + s2 % ps).reshape(-1)
    okf = ok.reshape(-1)
    vals = values.reshape(-1, *pool.shape[2:]).to(pool.dtype)
    # index 0 when nothing is kept; index_select keeps it on the device
    first = torch.argmax(okf.to(torch.int32)).reshape(1)
    tgt0 = tgt.index_select(0, first)
    fill = torch.where(okf.any(), vals.index_select(0, first),
                       flat.index_select(0, tgt0))
    tgt = torch.where(okf, tgt, tgt0)
    vals = torch.where(okf[:, None, None], vals, fill)
    flat.index_put_((tgt,), vals)
    return pool


def paged_decode_attention(cfg, p, x, pool_k, pool_v, block_tables, pos, *,
                           read_pages: int, window=0, offsets=None):
    """One-token decode over the paged pool. x (B,1,D); ``pos`` (B,) each
    lane's logical cache slot (parked lanes carry ``max_pages*ps``: the
    write drops); attention reads each lane's first ``read_pages``
    pages through the flash-decode kernel. Returns (out, pool_k, pool_v),
    the pools updated in place."""
    b = x.shape[0]
    ps = pool_k.shape[1]
    posv = pos.to(torch.int32)
    posb = (posv if offsets is None
            else posv - offsets.to(torch.int32))[:, None]
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    paged_write(pool_k, block_tables, posv, k[:, 0])
    paged_write(pool_v, block_tables, posv, v[:, 0])
    smax = read_pages * ps
    if offsets is None:
        kpos = torch.arange(smax, dtype=torch.int32,
                            device=x.device)[None].expand(b, smax)
    else:
        kpos = _cache_positions(smax, offsets)
    from repro_torch.kernels import paged_attention as pk
    out = pk.paged_decode_attn(cfg, q, pool_k, pool_v,
                               block_tables[:, :read_pages], posb, kpos,
                               window=window)
    return _out_proj(p, out), pool_k, pool_v


def paged_chunk_attention(cfg, p, x, pool_k, pool_v, block_tables, slot,
                          offsets, *, read_pages: int, window=0,
                          lane_mask=None):
    """Batched chunked-prefill attention over the paged pool: C prompt
    tokens written at logical slots [slot, slot+C) (``slot`` a scalar)
    through each lane's block table; ``lane_mask`` (B,) drops the writes
    of lanes not being prefilled. Returns (out (B,C,D), pool_k, pool_v),
    the pools updated in place."""
    b, c, _ = x.shape
    ps = pool_k.shape[1]
    steps = torch.arange(c, dtype=torch.int32, device=x.device)
    slots_b = (int(slot) + steps)[None, :].expand(b, c)
    qpos = slots_b - offsets.to(torch.int32)[:, None]
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        # pad queries have negative logical positions; clamp for rope
        # (their K/V and outputs are masked / discarded anyway)
        rp = qpos.clamp_min(0)
        q = apply_rope(q, rp, cfg.rope_theta)
        k = apply_rope(k, rp, cfg.rope_theta)
    paged_write(pool_k, block_tables, slots_b, k, lane_mask)
    paged_write(pool_v, block_tables, slots_b, v, lane_mask)
    kpos = _cache_positions(read_pages * ps, offsets)
    gk = gather_pages(pool_k, block_tables, read_pages)
    gv = gather_pages(pool_v, block_tables, read_pages)
    out = _scores_to_out(cfg, q, gk.to(q.dtype), gv.to(q.dtype), qpos, kpos,
                         causal=True, window=window)
    return _out_proj(p, out), pool_k, pool_v
