"""Batched serving loop, the greedy oracle (port of
``repro/serving/serve_loop.py``): prefill a batch of equal-length prompts
token by token into the contiguous cache (the decode step's own numerics),
then decode one token per step. The dense and MoE families (an MoE
model's capacity follows the batch of each step, so its streams may
differ from the engine's, as in the reference), and the recurrent
``ssm`` and ``hybrid`` families, which the engine does not serve (no
chunked prefill, as in the reference): their cache is the per-lane
recurrent state of ``registry.init_cache``; and whisper (``audio``),
whose encoder frames fill the cross-attention memory (``prefill_cross``)
before the prompt is prefilled. ``dist=`` serves the dense family (GLU
or the two-matrix MLP), the VLM's text and whisper tensor-parallel and
the MoE family expert-parallel (``serving/step.py``): every rank runs
this loop on its shard of the params, in lockstep, and returns the same
tokens; whisper's ranks take the same frames and project the cross K/V
of their own kv heads. With batch axes larger than 1 every rank is
handed the global batch, runs its data group's rows
(``DistContext.batch_rows``; whisper's frames split alike) on the
model axis alone (``model_only``) and all-gathers the results over the
batch axes, so every rank returns the whole batch; a batch the batch
axes do not divide is computed whole by every group.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.distributed.context import check_serving
from repro_torch.models import registry
from repro_torch.serving.step import greedy, make_decode_step


def _prefill(cfg, params, prompts: np.ndarray, max_len: int, frames,
             device, dist):
    """``prefill_with_decode`` on this data group's rows: (their last
    logits, their cache, first row, rows, the context they ran on: the
    model axis alone under ``dist``)."""
    check_serving(cfg, dist)
    b, plen = prompts.shape
    lo, n = (0, b) if dist is None else dist.batch_rows(b)
    run = None if dist is None else dist.model_only()
    rows = torch.as_tensor(prompts[lo:lo + n], device=device)
    if cfg.family == "audio" and frames is None:
        raise ValueError("whisper serving needs frames (B, S_enc, d_model): "
                         "pass generate(frames=...)")
    cache = registry.init_cache(cfg, n, max_len, device=device, dist=run)
    if cfg.family == "audio":
        from repro_torch.models import whisper
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.asarray(frames))
        cache["ck"], cache["cv"] = whisper.prefill_cross(
            cfg, params, frames[lo:lo + n].to(device),
            dtype=cache["k"].dtype, dist=run)
    logits = None
    for i in range(plen):
        logits, cache = registry.decode_step(cfg, params, cache,
                                             rows[:, i:i + 1], i, dist=run)
    return logits[:, -1], cache, lo, n, run


@torch.inference_mode()
def prefill_with_decode(cfg, params, prompts, max_len: int, frames=None,
                        device="cuda", dist=None):
    """Seed a contiguous cache by running the decode step over the prompt
    tokens. ``prompts`` (B, plen) ints. For whisper, ``frames`` (B,
    S_enc, d_model), a numpy array or a tensor, seed the cross-attention
    memory first (required; ignored by the other families, as in the
    reference). Returns (last logits (B, V) f32, cache); under ``dist``
    the logits are the rank's vocab shard of every row (gathered over
    the batch axes) and the cache holds its kv heads and its data
    group's rows."""
    prompts = np.asarray(prompts, np.int32)
    last, cache, *_ = _prefill(cfg, params, prompts, max_len, frames,
                               device, dist)
    if dist is not None:
        last = dist.gather_rows(last, prompts.shape[0])
    return last, cache


@torch.inference_mode()
def generate(cfg, params, prompts, *, max_new_tokens: int = 32,
             max_len: int | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None, frames=None,
             device="cuda", dist=None):
    """Greedy (or, with ``temperature`` > 0 and a ``torch.Generator``,
    sampled) generation for a batch of equal-length prompts on
    ``device``, where ``params`` must lie. Returns (tokens (B, plen+new)
    int32 numpy, stats). ``dist``: tensor-parallel, ``params`` the rank's
    shard (``serving/export.py::shard_params``); with batch axes, every
    rank returns every row (a draw is made over the whole batch's rows,
    so it is the one a single device makes from the same generator)."""
    prompts = np.asarray(prompts, np.int32)
    b, plen = prompts.shape
    max_len = max_len or (plen + max_new_tokens)
    last, cache, lo, n, run = _prefill(cfg, params, prompts, max_len,
                                       frames, device, dist)
    decode = make_decode_step(cfg, temperature=temperature, dist=run,
                              rows=None if n == b else (dist, lo, b))
    nxt = greedy(cfg, last, run)[0][:, None]
    out = [nxt]
    t0 = time.monotonic()
    for i in range(max_new_tokens - 1):
        nxt, cache, _, generator = decode(params, cache, nxt, plen + i,
                                          generator)
        out.append(nxt)
    gen = torch.cat(out, dim=1)
    if dist is not None:
        gen = dist.gather_rows(gen, b)
    gen = gen.cpu().numpy()                               # host sync
    dt = time.monotonic() - t0
    stats = {"decode_s": dt,
             "tok_per_s": b * (max_new_tokens - 1) / max(dt, 1e-9)}
    return np.concatenate([prompts, gen], axis=1), stats
