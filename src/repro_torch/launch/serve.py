"""Serving launcher (port of ``repro/launch/serve.py``): init (or restore)
a model, prune and pack it per BLaST, and serve greedy generation through
the continuous-batching engine (``serving/engine.py``): ragged prompt
lengths, FIFO admission, lane reuse. ``--oracle`` takes the token-by-token
``serve_loop.generate`` parity path instead; the recurrent families
(rwkv6 ``ssm``, zamba2 ``hybrid``), which have no chunked prefill, always
take it, and ``--frontdoor`` refuses them, as in the reference. A VLM
(internvl2-2b) serves text-only prompts, as the dense family does.
Whisper (``audio``) needs encoder frames, which the launcher does not
make: ``--arch whisper-large-v3`` exits before any weight is built (the
reference fails on its missing frames after building the model); serve
it through ``serve_loop.generate(frames=...)`` (with ``dist=``
tensor-parallel). ``_serve(..., dist=)`` serves a rank's shard of any
engine-servable tree, internvl2-2b's included; like the reference's,
this launcher has no ``--mesh``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --packed --batch 8 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
        --smoke --device cpu --prompt-len 16 --new-tokens 32 --batch 4 \
        [--packed] [--max-batch 2] [--ragged] [--prefill-chunk 8]

Runs on the GPU unless ``--device cpu`` is given; without a CUDA device
and without ``--device cpu`` it raises rather than fall back.

``--frontdoor`` serves a live multi-tenant trace through the asyncio
front door (``serving/frontend.py``): a batch tier queued up front,
interactive requests arriving mid-decode with an SLA deadline; ``--sla``
orders admission by priority class (with the anti-starvation aging
bound) and ``--preempt`` lets a page-blocked interactive head preempt
batch lanes, whose KV pages round-trip through host memory
(``serving/offload.py``). Prints the per-class TTFT split and the
preemption and offload counters.

Without ``--ckpt-dir`` only the params are built (no optimizer state):
``prune_and_pack`` takes the seeded f32 params to the serving layout,
and the f32 copy is dropped once packing is done.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--sparsity", type=float, default=0.8,
                    help="one-shot magnitude sparsity when no ckpt")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="engine lanes (default: --batch)")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--slab-k", type=int, default=8,
                    help="decode steps per slab (host syncs once per "
                         "slab; 1 = per-token baseline)")
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across the batch")
    ap.add_argument("--oracle", action="store_true",
                    help="token-by-token serve_loop.generate instead of "
                         "the continuous-batching engine")
    ap.add_argument("--contiguous", action="store_true",
                    help="dense (B, max_len) KV slab instead of the "
                         "paged page-pool cache (parity baseline)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache slots per KV pool page (paged mode)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="KV pool pages (default: contiguous-equivalent "
                         "max_batch * ceil(max_len / page_size))")
    ap.add_argument("--mixed", action="store_true",
                    help="stall-free mixed batching: fuse chunked "
                         "prefill into the decode step under a token "
                         "budget")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="tokens one mixed step may spend (0 = engine "
                         "default max_batch + prefill_chunk)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache: share prompt-prefix "
                         "KV pages across requests (paged mode only)")
    ap.add_argument("--frontdoor", action="store_true",
                    help="serve a live interactive+batch trace through "
                         "the asyncio front door and print the per-class "
                         "TTFT split")
    ap.add_argument("--sla", action="store_true",
                    help="SLA-class admission (SLAScheduler)")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt lower-priority lanes for a blocked "
                         "urgent head (KV pages offload to host memory)")
    ap.add_argument("--aging-s", type=float, default=30.0,
                    help="anti-starvation aging period (--sla)")
    ap.add_argument("--n-inter", type=int, default=6,
                    help="interactive arrivals in the frontdoor trace")
    ap.add_argument("--inter-tokens", type=int, default=8)
    ap.add_argument("--inter-gap-s", type=float, default=0.5,
                    help="gap between interactive arrivals")
    ap.add_argument("--deadline-s", type=float, default=0.5,
                    help="interactive SLA deadline (EDF within class)")
    ap.add_argument("--trace-out", default=None,
                    help="record request spans (obs/trace.py) and write "
                         "a Chrome/Perfetto trace JSON here")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="serve from a SEALED artifact "
                         "(serving/artifact.py), verified before a token "
                         "is served; a corrupt one exits with code 2")
    ap.add_argument("--validate-only", action="store_true",
                    help="with --artifact: verify and exit (exit code 2 "
                         "and the typed error on any corruption)")
    ap.add_argument("--seal", default=None, metavar="DIR",
                    help="pack (requires --packed) and seal the serving "
                         "weights into DIR as a validated artifact, then "
                         "exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (no fallback: cuda "
                         "without a GPU raises)")
    return ap


def resolve_device(name: str) -> str:
    """``name`` itself; "cuda" without a CUDA device raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return name


def _sync() -> None:
    """Wait for queued device work, so a host clock times it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def one_shot_masks(cfg, params, sparsity: float) -> dict:
    """The block masks of a one-shot magnitude prune at ``sparsity``
    (balanced: the same number of blocks kept in every block-column)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    from repro_torch.models import registry
    spec = dataclasses.replace(cfg.blast, s_init=sparsity, s_max=sparsity)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return masks


def prune_and_pack(cfg, params, sparsity: float, packed: bool, *,
                   masks: dict | None = None, pad_report=None,
                   times: dict | None = None):
    """Seeded or restored f32 params -> serving params: the one-shot
    magnitude prune at ``sparsity`` (or the given ``masks``), then the
    packed (``export.pack_params``) or the pruned-dense export. A model
    without BLaST is only cast. ``times`` is filled with the seconds of
    the prune and the export (device work included)."""
    from repro_torch.serving import export
    t0 = time.monotonic()
    if masks is None:
        masks = (one_shot_masks(cfg, params, sparsity)
                 if cfg.blast.enabled else {})
    _sync()
    t1 = time.monotonic()
    out = (export.pack_params(cfg, params, masks, pad_report=pad_report)
           if packed else export.prune_params(cfg, params, masks))
    _sync()
    if times is not None:
        times.update(prune_s=t1 - t0, pack_s=time.monotonic() - t1)
    return out


def main(argv=None):
    """Run the launcher on ``argv`` (default: the command line). Returns
    a summary dict (config, seconds of each set-up stage, the memory
    report, the generated tokens of each request and the serving stats),
    or None after ``--validate-only`` and ``--seal``."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import export

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "audio":
        raise SystemExit(
            f"{cfg.name} ({cfg.family!r}) needs encoder frames, which this "
            "launcher does not make: serve it through "
            "repro_torch.serving.serve_loop.generate(frames=...)")
    if args.validate_only and not args.artifact:
        raise SystemExit("--validate-only requires --artifact")
    if args.seal and not args.packed:
        raise SystemExit("--seal requires --packed (artifacts hold packed "
                         "serving params)")
    device = resolve_device(args.device)

    if args.artifact:
        from repro_torch.serving import artifact as art
        try:
            params, manifest = art.load(args.artifact, cfg,
                                        run_canaries=True, device=device)
        except art.ArtifactError as e:
            print(f"artifact INVALID ({type(e).__name__}): {e}")
            raise SystemExit(2)
        print(f"artifact OK: fingerprint {manifest['fingerprint'][:12]}…, "
              f"{len(manifest['checksums'])} arrays, "
              f"{len(manifest.get('canaries', []))} canaries replayed")
        if args.validate_only:
            return None
        tokens, stats = _serve(cfg, params, args, device)
        return {"config": cfg.name, "tokens": tokens, "stats": stats}

    t0 = time.monotonic()
    params = registry.init_params(cfg, 0, device)
    masks = None
    if args.ckpt_dir:
        from repro_torch.checkpointing.checkpoint import Checkpointer
        tree = Checkpointer(args.ckpt_dir).restore(
            {"params": params, "masks": registry.init_masks(cfg, params)})
        params, masks = tree.pop("params"), tree.pop("masks")
    _sync()
    times = {"init_s": time.monotonic() - t0}
    pad_report: dict = {}
    params = prune_and_pack(cfg, params, args.sparsity, args.packed,
                            masks=masks, pad_report=pad_report, times=times)
    memory = export.memory_report(cfg, params)
    print("serving memory:", memory)
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in times.items()))

    if args.seal:
        from repro_torch.serving import artifact as art
        manifest = art.seal(cfg, params, args.seal, pad=pad_report or None)
        print(f"sealed {args.seal}: fingerprint "
              f"{manifest['fingerprint'][:12]}…, "
              f"{len(manifest['checksums'])} arrays, "
              f"{len(manifest['canaries'])} canaries")
        return None
    tokens, stats = _serve(cfg, params, args, device)
    return {"config": cfg.name, "seconds": times, "memory": memory,
            "tokens": tokens, "stats": stats}


def _print_rows(rows) -> None:
    for r in rows:
        print(" ".join(str(int(t)) for t in r))


def _engine_prompts(cfg, args, rng):
    """The engine path's prompts: ``args.batch`` of ``args.prompt_len``
    tokens (with ``--ragged`` of ``prompt_len // 2`` to ``prompt_len``),
    drawn from ``rng``."""
    lens = (rng.integers(max(1, args.prompt_len // 2),
                         args.prompt_len + 1, size=args.batch)
            if args.ragged else [args.prompt_len] * args.batch)
    return [rng.integers(0, cfg.vocab_size, size=(int(p),))
            .astype(np.int32) for p in lens]


def _serve(cfg, params, args, device="cuda", dist=None):
    """Serve the launcher's prompts on ``params``. Returns (the tokens
    each request generated, a list of arrays (empty for the front door),
    the stats). ``dist``: this rank's shard under tensor (or expert)
    parallelism, every rank serving the same prompts."""
    from repro_torch.models import registry
    from repro_torch.serving import engine, serve_loop

    rng = np.random.default_rng(0)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    if args.frontdoor:
        if dist is not None:
            raise NotImplementedError("the front door under dist= is not "
                                      "ported (ROADMAP §1 item 4)")
        if not registry.supports_prefill_chunk(cfg):
            raise SystemExit(f"--frontdoor needs an engine-servable "
                             f"family; {cfg.family!r} is not")
        stats = _frontdoor(cfg, params, args, rng, tracer, device)
        _write_trace(args, tracer)
        return [], stats
    if args.oracle or not registry.supports_prefill_chunk(cfg):
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(args.batch, args.prompt_len))
        toks, stats = serve_loop.generate(
            cfg, params, prompts, max_new_tokens=args.new_tokens,
            device=device, dist=dist)
        print(f"generated {toks.shape} — {stats['tok_per_s']:.1f} tok/s")
        gen = list(toks[:, args.prompt_len:])
        _print_rows(gen[:2])
        return gen, stats
    prompts = _engine_prompts(cfg, args, rng)
    toks, stats = engine.generate(
        cfg, params, prompts, max_new_tokens=args.new_tokens,
        max_batch=args.max_batch or args.batch,
        prefill_chunk=args.prefill_chunk, slab_k=args.slab_k,
        paged=not args.contiguous, page_size=args.page_size,
        n_pages=args.n_pages or None, prefix_cache=args.prefix_cache,
        mixed=args.mixed,
        prefill_token_budget=args.prefill_token_budget or None,
        tracer=tracer, device=device, dist=dist)
    print(f"generated {len(toks)} seqs — {stats['tok_per_s']:.1f} tok/s "
          f"({stats['decode_slabs']} slabs of {args.slab_k}, "
          f"{stats['prefill_chunks']} prefill chunks, "
          f"peak_kv_kib={stats['peak_kv_bytes'] / 1024:.1f}, "
          f"ttft_p95_ms={stats['ttft_p95_s'] * 1e3:.1f})"
          + (f" prefix_hit_rate={stats['prefix_hit_rate']:.2f} "
             f"skipped={stats['prefill_tokens_skipped']}"
             if args.prefix_cache else "")
          + (f" mixed_steps={stats['mixed_steps']} "
             f"stalled={stats['stalled_decode_steps']}"
             if args.mixed else ""))
    gen = [t[p.size:] for p, t in zip(prompts, toks)]
    _print_rows(gen[:2])
    _write_trace(args, tracer)
    return gen, stats


def _write_trace(args, tracer):
    if tracer is None:
        return
    from repro_torch.obs.export import write_chrome_trace
    write_chrome_trace(args.trace_out, tracer.records)
    print(f"wrote {len(tracer.records)} spans to {args.trace_out} "
          f"(open in https://ui.perfetto.dev)")


def _frontdoor(cfg, params, args, rng, tracer=None, device="cuda"):
    """The asyncio front door over a live multi-tenant trace: batch jobs
    fill the lanes, interactive requests trickle in and (with --sla /
    --preempt) jump the queue or preempt a batch lane's KV to host.
    Streams are consumed concurrently; per-class TTFT is measured from
    each request's own submission. Returns the engine's stats."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.frontend import AsyncEngine
    from repro_torch.serving.scheduler import (BATCH, INTERACTIVE,
                                               FIFOScheduler, SLAScheduler)

    max_batch = args.max_batch or 2
    max_len = max(args.prompt_len + args.new_tokens + 8, 32)

    def build():
        sched = (SLAScheduler(max_batch, max_len, aging_s=args.aging_s)
                 if args.sla else FIFOScheduler(max_batch, max_len))
        return Engine(cfg, params, max_batch=max_batch, max_len=max_len,
                      prefill_chunk=args.prefill_chunk,
                      slab_k=args.slab_k, page_size=args.page_size,
                      n_pages=args.n_pages or None, scheduler=sched,
                      mixed=args.mixed, preempt=args.preempt,
                      tracer=tracer, device=device)

    # warm both request shapes outside the served trace
    warm = build()
    warm.submit(np.ones(args.prompt_len, np.int32), 4, priority=BATCH)
    warm.submit(np.ones(max(args.prompt_len // 2, 1), np.int32), 4,
                priority=INTERACTIVE)
    warm.run()

    eng = build()
    lat = {"batch": [], "interactive": []}

    async def one(front, prompt, tokens, klass, *, delay=0.0, **kw):
        """One client: wait for its arrival time, submit, stream. TTFT
        is measured from BEFORE the submit, so the ack latency and the
        queue wait both count."""
        await asyncio.sleep(delay)
        t0 = time.monotonic()
        stream = await front.submit_async(prompt, tokens, **kw)
        first = None
        async for _ in stream:
            if first is None:
                first = time.monotonic() - t0
        await stream.result()
        lat[klass].append((first, time.monotonic() - t0))

    async def drive():
        async with AsyncEngine(eng) as front:
            tasks = []
            for _ in range(args.batch):
                p = rng.integers(0, cfg.vocab_size, args.prompt_len)
                tasks.append(one(front, p.astype(np.int32),
                                 args.new_tokens, "batch",
                                 priority=BATCH))
            for k in range(args.n_inter):
                p = rng.integers(0, cfg.vocab_size,
                                 max(args.prompt_len // 2, 1))
                tasks.append(one(front, p.astype(np.int32),
                                 args.inter_tokens, "interactive",
                                 delay=(k + 1) * args.inter_gap_s,
                                 priority=INTERACTIVE,
                                 deadline_s=args.deadline_s))
            await asyncio.gather(*tasks)

    asyncio.run(drive())
    for klass in ("interactive", "batch"):
        if not lat[klass]:
            continue
        ttft = np.array([t for t, _ in lat[klass]])
        e2e = np.array([e for _, e in lat[klass]])
        print(f"{klass:>12}: n={len(ttft)} "
              f"ttft p50={np.percentile(ttft, 50) * 1e3:7.1f}ms "
              f"p95={np.percentile(ttft, 95) * 1e3:7.1f}ms   "
              f"e2e p95={np.percentile(e2e, 95) * 1e3:7.1f}ms")
    st = dict(eng.stats)
    print(f"{'engine':>12}: {st['e2e_tok_per_s']:.1f} tok/s e2e, "
          f"preemptions={st['preemptions']} restores={st['restores']} "
          f"offloaded_pages={st['offloaded_pages']} "
          f"offload_bytes_peak={st['offload_bytes_peak']:,} "
          f"stalled_decode_steps={st['stalled_decode_steps']}")
    return st


if __name__ == "__main__":
    main()
