"""Serving steps (port of ``repro/serving/step.py``): prefill, chunked
prefill and the decode slab over the contiguous cache and the paged
pool, the mixed decode+prefill step, the copy-on-write page copy, the
page movers of preemption and the one-token decode step of
``serve_loop``.

The reference's ``lax.scan`` slab becomes a loop of ``k_steps`` decode
steps whose whole state stays on the device: nothing in the loop reads a
value back to the host, so the engine syncs once per slab. Caches are
updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import registry


def make_prefill_step(cfg):
    """prefill(params, tokens (B,S)) -> last-token logits (B, V) f32,
    through the training forward (no cache)."""
    def prefill_step(params, tokens):
        logits, _ = registry.forward(cfg, params, tokens, masks=None)
        return logits[:, -1]
    return prefill_step


def make_prefill_chunk_step(cfg):
    """prefill(params, cache, tokens, slot, offsets, lane_mask) ->
    (last_logits (B, V) f32, cache): one (B, C) chunk of right-aligned
    prompt tokens through the model into the contiguous cache at slots
    [slot, slot+C), lanes outside ``lane_mask`` untouched."""
    def prefill_step(params, cache, tokens, slot, offsets, lane_mask):
        logits, cache = registry.prefill_chunk(
            cfg, params, cache, tokens, slot, offsets, lane_mask=lane_mask)
        return logits[:, -1], cache
    return prefill_step


def _run_slab(k_steps, max_len, eos_id, cache, state, park, step_fn):
    """``k_steps`` greedy decode steps over per-lane state, shared by the
    contiguous and paged slabs (they differ only in ``park``, a slot the
    cache write drops, and in ``step_fn``).

    A lane dies mid-slab when it emits ``eos_id``, exhausts its budget,
    runs out of cache (``frontier`` reaching ``max_len``) or produces
    non-finite logits; a dead lane writes at ``park`` and its frontier
    and budget freeze, so its tokens after the stop point are garbage the
    host discards. A lane whose logits go non-finite is marked
    ``faulted`` and dies without advancing.

    ``state["poison"]`` (f32 (B,), normally zeros) is the fault-injection
    port: added to the first step's logits, then zeroed in the returned
    state. Adding +0.0 leaves a healthy lane's logits bitwise unchanged.
    ``step_fn(cache, tokens (B,1), write_pos (B,)) -> (logits, cache)``.
    Returns (tokens (B, k_steps) int32, new state, cache)."""
    pending, frontier = state["pending"], state["frontier"]
    remaining, live = state["remaining"], state["live"]
    faulted = state["faulted"]
    toks = []
    for t in range(k_steps):
        write_pos = torch.where(live, frontier, park)
        logits, cache = step_fn(cache, pending[:, None], write_pos)
        last = logits[:, -1]
        if t == 0:
            last = last + state["poison"][:, None]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        bad = live & ~torch.isfinite(last).all(dim=-1)
        faulted = faulted | bad
        ok = live & ~bad
        frontier = torch.where(ok, frontier + 1, frontier)
        remaining = torch.where(ok, remaining - 1, remaining)
        died = (remaining <= 0) | (frontier >= max_len) | bad
        if eos_id is not None:
            died |= nxt == eos_id
        live = live & ~died
        pending = torch.where(live, nxt, pending)
        toks.append(nxt)
    state = dict(state, pending=pending, frontier=frontier,
                 remaining=remaining, live=live, faulted=faulted,
                 poison=torch.zeros_like(state["poison"]))
    return torch.stack(toks, dim=1), state, cache


def make_decode_slab_step(cfg, k_steps: int, max_len: int,
                          eos_id: int | None = None):
    """slab(params, cache, state) -> (tokens (B, k_steps), new state,
    cache) over the contiguous cache. ``state`` holds the (B,) device
    vectors pending, frontier, offsets, remaining, live, poison and
    faulted. A
    dead lane parks at slot ``max_len``, past the slab, so its write
    drops."""
    def slab(params, cache, state):
        offsets = state["offsets"]

        def step_fn(cache, tokens, write_pos):
            return registry.decode_step(cfg, params, cache, tokens,
                                        write_pos, offsets=offsets)

        return _run_slab(k_steps, max_len, eos_id, cache, state, max_len,
                         step_fn)
    return slab


def make_paged_prefill_chunk_step(cfg):
    """prefill(params, cache, tokens, slot, offsets, lane_mask,
    block_tables, read_pages) -> (last_logits (B, V) f32, cache): one
    (B, C) chunk of right-aligned prompt tokens through the model, its
    K/V written through the block tables (lanes outside ``lane_mask``
    untouched)."""
    def prefill_step(params, cache, tokens, slot, offsets, lane_mask,
                     block_tables, read_pages):
        logits, cache = registry.paged_prefill_chunk(
            cfg, params, cache, tokens, slot, offsets, block_tables,
            read_pages=read_pages, lane_mask=lane_mask)
        return logits[:, -1], cache
    return prefill_step


def make_paged_decode_slab_step(cfg, k_steps: int, max_len: int,
                                page_size: int, eos_id: int | None = None):
    """slab(params, cache, state, read_pages) -> (tokens (B, k_steps),
    new state, cache). ``state`` holds the (B,) device vectors pending,
    frontier, offsets, remaining, live, poison, faulted and ``bt``, each
    lane's
    (max_pages,) block table, constant through a slab. A dead lane parks
    at logical slot ``max_pages * page_size``, past the table end, so
    its write drops. The engine guarantees ``read_pages * page_size >=
    min(max frontier + k_steps, max_len)``."""
    def slab(params, cache, state, read_pages):
        offsets, bt = state["offsets"], state["bt"]

        def step_fn(cache, tokens, write_pos):
            return registry.paged_decode_step(
                cfg, params, cache, tokens, write_pos, bt,
                read_pages=read_pages, offsets=offsets)

        return _run_slab(k_steps, max_len, eos_id, cache, state,
                         bt.shape[1] * page_size, step_fn)
    return slab


def make_mixed_step(cfg):
    """mixed(params, cache, tokens (B,W), starts (B,), q_lens (B,),
    offsets (B,), block_tables, read_pages, poison (B,)) ->
    (next_tokens (B,) int32, faulted (B,) bool, cache): one pass of the
    stack over per-lane query runs. Decode lanes give one token (q_len 1
    at their frontier), admitting lanes a prompt chunk (q_len c at their
    prompt position), idle lanes ride along at q_len 0. Each lane's next
    token is the argmax of its last valid row (garbage for a mid-prompt
    or idle lane, which the host ignores); ``poison`` (f32, normally
    zeros: the slab's injection port) is added to that row, and
    ``faulted`` is each lane's finite check on it. ``read_pages`` must
    cover every lane's start + q_len."""
    def mixed_step(params, cache, tokens, starts, q_lens, offsets,
                   block_tables, read_pages, poison):
        logits, cache = registry.paged_prefill_chunk(
            cfg, params, cache, tokens, starts, offsets, block_tables,
            read_pages=read_pages, q_lens=q_lens)
        row = (q_lens.to(torch.int64) - 1).clamp_min(0)
        last = torch.gather(
            logits, 1, row[:, None, None].expand(-1, 1, logits.shape[-1]))
        last = last[:, 0] + poison[:, None]
        faulted = ~torch.isfinite(last).all(dim=-1)
        return torch.argmax(last, dim=-1).to(torch.int32), faulted, cache
    return mixed_step


def make_copy_pages_step():
    """copy(cache, src (n,), dst (n,)) -> cache: duplicate pool pages
    ``src`` into ``dst`` across every layer, K and V, in place (the
    copy-on-write of a shared boundary page). The whole page is copied;
    rows past the shared part are stale, hidden by the causal mask until
    the lane writes them."""
    def copy_pages(cache, src, dst):
        src, dst = src.long(), dst.long()
        for name in ("k", "v"):
            c = cache[name]
            c.index_copy_(1, dst, c.index_select(1, src))
        return cache
    return copy_pages


def make_gather_pages_step():
    """gather(cache, pages (n,)) -> (k, v): pool pages ``pages`` across
    every layer, (layers, n, page_size, KV, hd) each, new tensors on the
    cache's device (the download half of preemption)."""
    def gather_pages(cache, pages):
        pages = pages.long()
        return (cache["k"].index_select(1, pages),
                cache["v"].index_select(1, pages))
    return gather_pages


def make_scatter_pages_step():
    """scatter(cache, dst (n,), k, v) -> cache: write page data ``k``,
    ``v`` (layers, n, page_size, KV, hd) into pool pages ``dst``, in
    place (the restore half of preemption)."""
    def scatter_pages(cache, dst, k, v):
        dst = dst.long()
        cache["k"].index_copy_(1, dst, k)
        cache["v"].index_copy_(1, dst, v)
        return cache
    return scatter_pages


def make_decode_step(cfg, temperature: float = 0.0):
    """decode(params, cache, tokens (B,1), pos, generator) -> (next (B,1)
    int32, cache, last logits (B, V), generator) over the contiguous
    cache. Greedy at ``temperature`` 0; above it, a draw from
    softmax(logits / temperature) with ``generator`` (a
    ``torch.Generator`` on the logits' device), so parity with the
    reference holds for greedy decoding only."""
    def decode_step(params, cache, tokens, pos, generator=None):
        logits, cache = registry.decode_step(cfg, params, cache, tokens,
                                             pos)
        last = logits[:, -1]
        if temperature > 0.0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None].to(torch.int32), cache, last, generator
    return decode_step
