"""Serving steps over the paged pool (port of the paged part of
``repro/serving/step.py``): chunked prefill and the decode slab.

The reference's ``lax.scan`` slab becomes a loop of ``k_steps`` decode
steps whose whole state stays on the device: nothing in the loop reads a
value back to the host, so the engine syncs once per slab.
"""
from __future__ import annotations

import torch

from repro_torch.models import registry


def _run_slab(k_steps, max_len, eos_id, cache, state, park, step_fn):
    """``k_steps`` greedy decode steps over per-lane state.

    A lane dies mid-slab when it emits ``eos_id``, exhausts its budget,
    runs out of cache (``frontier`` reaching ``max_len``) or produces
    non-finite logits; a dead lane writes at ``park`` (a slot the cache
    write drops) and its frontier and budget freeze, so its tokens after
    the stop point are garbage the host discards. A lane whose logits go
    non-finite is marked ``faulted`` and dies without advancing.
    ``step_fn(cache, tokens (B,1), write_pos (B,)) -> (logits, cache)``.
    Returns (tokens (B, k_steps) int32, new state, cache)."""
    pending, frontier = state["pending"], state["frontier"]
    remaining, live = state["remaining"], state["live"]
    faulted = state["faulted"]
    toks = []
    for _ in range(k_steps):
        write_pos = torch.where(live, frontier, park)
        logits, cache = step_fn(cache, pending[:, None], write_pos)
        last = logits[:, -1]
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
                 remaining=remaining, live=live, faulted=faulted)
    return torch.stack(toks, dim=1), state, cache


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
    frontier, offsets, remaining, live, faulted and ``bt``, each lane's
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
