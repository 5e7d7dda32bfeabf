"""GQA attention (port of ``repro/models/attention.py``): the
full-sequence causal or windowed attention of training, whisper's
bidirectional encoder attention and its cross-attention into the encoder
memory, and attention over the serving caches: the contiguous
``(B, Smax, KV, hd)`` slab and the paged KV pool.

The pool ``(n_pages, page_size, KV, hd)`` is shared by every lane; lane
b's logical cache slot ``s`` lives at pool page ``block_tables[b, s //
page_size]``, row ``s % page_size``. Slot numbering, rope positions and
masking (``_cache_positions``) are the reference's and the same for both
layouts. Paged decode attention goes through the hand-written
flash-decode kernel (``kernels/paged_attention.py``); the contiguous
path and every prefill or mixed chunk stay plain torch (softmax over
the scores), as the reference leaves them to XLA.

Under ``dist`` a rank computes its query heads (``local_heads``,
``shard_local``) and its ``wo`` rows, so the output projection is a
partial sum that the transformer reduces over the model axis: an
all-reduce, or with sequence parallelism a reduce-scatter to the
rank's S shard (``transformer._heads_out``). The full-sequence
attention then sees the whole sequence gathered along S, so its RoPE
positions are those of the gathered sequence, 0 to S - 1.

Unlike the reference, the cache writes update the slab or pool IN
PLACE, which saves one cache copy per layer per step; the functions that
write return the same tensors they were given. A write the reference
drops (a parked lane, a masked lane or pad token) leaves the cache
bitwise unchanged, with no host sync.
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


def local_heads(cfg, dist) -> tuple[int, int, int, int]:
    """(first query head, query heads, first kv head, kv heads) that this
    rank computes under ``dist`` (all of them without one). Query heads
    split over the model axis where it divides them (else every rank
    computes all); kv heads split where it divides them too, and
    otherwise each rank takes the kv heads its own query heads read
    (Llama-3.2-1B at tp 16: 2 query heads and 1 of the 8 kv heads a
    rank). A rank's query heads must then read a run of kv heads with
    one group size; other splits raise."""
    h, kv = eff_heads(cfg)
    if dist is None or not dist.shards(h):
        return 0, h, 0, kv
    hl, r = h // dist.tp, dist.model_rank
    if dist.shards(kv):
        kvl = kv // dist.tp
        return r * hl, hl, r * kvl, kvl
    g = h // kv
    lo, hi = (r * hl) // g, ((r + 1) * hl - 1) // g + 1
    n = hi - lo
    if hl % n or any((r * hl + j) // g - lo != j // (hl // n)
                     for j in range(hl)):
        raise NotImplementedError(
            f"{h} query heads over {kv} kv heads do not split {dist.tp} "
            "ways into equal groups (ROADMAP §1 item 4)")
    return r * hl, hl, lo, n


def shard_local(cfg, p, dist):
    """The attention params this rank computes with: ``p`` as sharded
    (``distributed/sharding.py``), with replicated kv projections
    narrowed to this rank's kv heads (``local_heads``). Where the query
    heads split, a replicated leaf serves only this rank's heads (the
    narrowed kv projections, the q/k norms), so its gradient is this
    rank's part of the whole: it passes ``copy_to_model``, whose backward
    sums the parts over the model axis (an identity outside autograd)."""
    if dist is None:
        return p
    h, _ = eff_heads(cfg)
    _, _, lo, n = local_heads(cfg, dist)
    narrow = p["wk"].shape[-2] != n
    if dist.shards(h):
        rep = [k for k in ("q_norm", "k_norm") if k in p]
        if narrow:
            rep += [k for k in ("wk", "wv", "bk", "bv") if k in p]
        if rep:
            p = dict(p)
            for k in rep:
                p[k] = dist.copy_to_model(p[k])
    if not narrow:
        return p
    p = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            p[name] = p[name].narrow(-2, lo, n)
    return p


def zero_padded_heads(cfg, p, dist=None) -> None:
    """Zero, in place, the ``wq`` columns and ``wo`` rows of the query
    heads that ``pad_heads_to`` adds (heads >= ``num_heads``) in one
    (possibly layer-stacked) attention param dict, so the padding adds
    nothing to the output. Under GQA, live head h then reads kv head
    h // G with the padded G (qwen2-7b: 32 // 4 = 8, not 28 // 4 = 7), so
    a real checkpoint's heads would have to be placed to match; MHA pads
    its kv heads too and keeps head h on kv head h. Under ``dist`` ``p``
    is this rank's shard, whose local head j is global head ``first +
    j`` (``local_heads``): whisper at model 2 pads 20 heads to 32, so
    rank 0's 16 are live and rank 1 holds 4 live and 12 padded."""
    h, _ = eff_heads(cfg)
    if h > cfg.num_heads:
        first = 0
        if p["wq"].shape[-2] < h:
            if dist is None:
                raise ValueError("a shard of the query heads needs dist=")
            first = local_heads(cfg, dist)[0]
        live = min(max(cfg.num_heads - first, 0), p["wq"].shape[-2])
        with torch.no_grad():
            p["wq"][..., live:, :].zero_()
            p["wo"][..., live:, :, :].zero_()


def attn_param_specs(cfg, cross: bool = False) -> dict:
    """ParamSpec dict for one attention block (stacked by the caller). A
    cross-attention block (``cross``) has the same four projections: K
    and V project the encoder memory instead of the block's input."""
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


def _project_q(cfg, p, x):
    """-> q (B,S,H,hd), with its bias and norm where the config has
    them."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    return q


def _project_qkv(cfg, p, x, kv_src=None):
    """-> q (B,S,H,hd), k, v (B,Skv,KV,hd); K and V project ``kv_src``
    (B,Skv,D) when given (cross-attention), else ``x``."""
    dt = x.dtype
    kv_src = x if kv_src is None else kv_src
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return _project_q(cfg, p, x), k, v


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
    if causal or window:
        # unmasked (bidirectional, cross) attention skips the all-True
        # mask: one (B, KV, G, Sq, Sk) f32 copy less, the same numbers
        mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool,
                          device=q.device)
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
                        q_chunk=1024, kv_src=None, kv_positions=None):
    """Full-sequence attention: training and prefill self-attention,
    whisper's encoder (``causal=False``) and its cross-attention (K and V
    from ``kv_src`` (B,Skv,D), key positions ``kv_positions`` (B,Skv);
    no rope there, as in the reference). x (B,S,D); positions (B,S).
    Queries run in chunks of ``q_chunk`` when S is a multiple of it,
    which bounds the score transient to (q_chunk, Skv).

    Returns (out (B,S,D), (k, v))."""
    q, k, v = _project_qkv(cfg, p, x, kv_src)
    kpos = positions if kv_positions is None else kv_positions
    if cfg.rope_theta > 0 and kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kpos, cfg.rope_theta)
    s = q.shape[1]
    if s <= q_chunk or s % q_chunk:
        out = _scores_to_out(cfg, q, k, v, positions, kpos, causal, window)
    else:
        out = torch.cat([
            _scores_to_out(cfg, q[:, i:i + q_chunk], k, v,
                           positions[:, i:i + q_chunk], kpos, causal,
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


def decode_attention(cfg, p, x, cache_k, cache_v, pos, *, window=0,
                     cross=False, offsets=None):
    """One-token decode over the contiguous cache. x (B,1,D); cache_k/v
    (B,Smax,KV,hd); ``pos`` the new token's cache slot: an int (every
    lane writes the same slot, ``serve_loop``) or a (B,) tensor (per-lane
    frontiers; a slot >= Smax, where the engine parks finished lanes,
    drops the write). With ``offsets`` (B,) lane b's logical position is
    ``pos[b] - offsets[b]``. With ``cross`` the caches are the static
    projected encoder memory: only Q is projected, nothing is written,
    and every slot is attended (no causal mask). Returns (out, cache_k,
    cache_v), the caches updated in place."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    per_lane = torch.is_tensor(pos) and pos.dim() > 0
    posv = (pos.to(torch.int32) if per_lane else
            torch.full((b,), int(pos), dtype=torch.int32, device=x.device))
    posb = (posv if offsets is None
            else posv - offsets.to(torch.int32))[:, None]
    if cross:
        q = _project_q(cfg, p, x)
    else:
        q, k, v = _project_qkv(cfg, p, x)
        if cfg.rope_theta > 0:
            q = apply_rope(q, posb, cfg.rope_theta)
            k = apply_rope(k, posb, cfg.rope_theta)
        if per_lane:
            # each lane owns its row: clamp the slot and write the row's
            # own value back where the reference drops the write
            lanes = torch.arange(b, device=x.device)
            ok = (posv >= 0) & (posv < smax)
            slot = posv.clamp(0, smax - 1).long()
            for cache, new in ((cache_k, k), (cache_v, v)):
                cur = cache[lanes, slot]
                cache[lanes, slot] = torch.where(
                    ok[:, None, None], new[:, 0].to(cache.dtype), cur)
        else:
            # the reference's dynamic_update_slice clamps the start slot
            s0 = min(max(int(pos), 0), smax - 1)
            cache_k[:, s0] = k[:, 0].to(cache_k.dtype)
            cache_v[:, s0] = v[:, 0].to(cache_v.dtype)
    if offsets is None:
        kpos = torch.arange(smax, dtype=torch.int32,
                            device=x.device)[None].expand(b, smax)
    else:
        kpos = _cache_positions(smax, offsets)
    # the causal mask at the query's position also hides the garbage
    # cache tail
    out = _scores_to_out(cfg, q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                         posb, kpos, causal=not cross, window=window)
    return _out_proj(p, out), cache_k, cache_v


def chunk_attention(cfg, p, x, cache_k, cache_v, slot, offsets, *,
                    window=0, lane_mask=None):
    """Batched chunked-prefill attention over the contiguous cache: C
    prompt tokens written at cache slots [slot, slot+C) (``slot`` an
    int); lane b's token at slot s has logical position ``s -
    offsets[b]``. Lanes outside ``lane_mask`` (B,) keep their cache rows
    bitwise unchanged (they are decoding while new lanes prefill behind
    their frontier). Returns (out (B,C,D), cache_k, cache_v), the caches
    updated in place."""
    b, c, _ = x.shape
    steps = torch.arange(c, dtype=torch.int32, device=x.device)
    qpos = (int(slot) + steps)[None, :] - offsets.to(torch.int32)[:, None]
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        # pad queries have negative logical positions; clamp for rope
        # (their K/V and outputs are masked / discarded anyway)
        rp = qpos.clamp_min(0)
        q = apply_rope(q, rp, cfg.rope_theta)
        k = apply_rope(k, rp, cfg.rope_theta)
    # the reference's dynamic slice clamps the start so the chunk fits
    s0 = min(max(int(slot), 0), cache_k.shape[1] - c)
    for cache, new in ((cache_k, k), (cache_v, v)):
        new = new.to(cache.dtype)
        if lane_mask is not None:
            new = torch.where(lane_mask[:, None, None, None], new,
                              cache[:, s0:s0 + c])
        cache[:, s0:s0 + c] = new
    kpos = _cache_positions(cache_k.shape[1], offsets)
    out = _scores_to_out(cfg, q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                         qpos, kpos, causal=True, window=window)
    return _out_proj(p, out), cache_k, cache_v


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
                          lane_mask=None, q_lens=None):
    """Batched chunked-prefill attention over the paged pool: C tokens
    per lane written through each lane's block table from ``slot``, an
    int (every lane from the same slot: group prefill) or a (B,) tensor
    of per-lane start slots. ``lane_mask`` (B,) drops the writes of lanes
    not being prefilled; with ``q_lens`` (B,) lane b's tokens [0,
    q_lens[b]) are real and the rest of its row is padding whose writes
    drop and whose outputs the caller discards. That is the mixed
    decode+prefill step: decode lanes at q_len 1 from their frontier,
    admitting lanes at a chunk from their prompt position, idle lanes at
    0. Returns (out (B,C,D), pool_k, pool_v), the pools updated in
    place."""
    b, c, _ = x.shape
    ps = pool_k.shape[1]
    steps = torch.arange(c, dtype=torch.int32, device=x.device)
    if torch.is_tensor(slot) and slot.dim() > 0:
        slots_b = slot.to(torch.int32)[:, None] + steps[None, :]
    else:
        slots_b = (int(slot) + steps)[None, :].expand(b, c)
    qpos = slots_b - offsets.to(torch.int32)[:, None]
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        # pad queries have negative logical positions; clamp for rope
        # (their K/V and outputs are masked / discarded anyway)
        rp = qpos.clamp_min(0)
        q = apply_rope(q, rp, cfg.rope_theta)
        k = apply_rope(k, rp, cfg.rope_theta)
    wmask = lane_mask
    if q_lens is not None:
        valid = steps[None, :] < q_lens.to(torch.int32)[:, None]
        if wmask is None:
            wmask = valid
        else:
            wmask = (wmask[:, None] if wmask.dim() == 1 else wmask) & valid
    paged_write(pool_k, block_tables, slots_b, k, wmask)
    paged_write(pool_v, block_tables, slots_b, v, wmask)
    kpos = _cache_positions(read_pages * ps, offsets)
    gk = gather_pages(pool_k, block_tables, read_pages)
    gv = gather_pages(pool_v, block_tables, read_pages)
    out = _scores_to_out(cfg, q, gk.to(q.dtype), gv.to(q.dtype), qpos, kpos,
                         causal=True, window=window)
    return _out_proj(p, out), pool_k, pool_v
