#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
nvcc, holds each against its plain PyTorch version at the shapes its
path gives it (and times it beside its bound and a library yardstick),
then drives the port's two paths on Llama-3.2-1B at full width and
depth with seeded random weights.

Serving: packed Llama-3.2-1B through the continuous-batching engine: the
one-shot 80% block prune of the JAX launcher (gate and up masks differ,
so the split fused-GLU kernel runs), then a short run whose up weight
takes gate's mask (the joint kernel). Each serving run resets the kernel
launch counters just before and reads them just after, and fails unless
every kernel of its path launched. The packed output is checked against
a pruned-dense run of the same weights (plain torch.matmul MLP): at each
of the 16 layers on the dense run's hidden states, end to end through
the engine on the model's first two layers, and in next-token logits at
full depth (see ``phase_e2e``). A profiled window of decode slabs shows
where a step's time goes.

Training: 12 steps of the BLaST trainer (``train_loop.train``: masked
dense with in-step prune-and-grow, f32 params, bf16 compute) on 8 x 128
synthetic tokens, checked for a falling finite loss, exact per-column
keep counts after every refresh and exactly-zero pruned blocks in the
params and both Adam moments; no kernel launches there. Then the trained
masks are packed layer by layer and the fine-tuning gradient through
``make_bspmm_trainable`` (forward ``bspmm``, dX ``bspmm_t``) is held
against the trainer's own masked-dense STE gradient at all 16 layers.

Prints JSON lines; the line before the last is a ``kernels`` summary and
the last is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero without that line. Needs one CUDA card.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DEVICE = "cuda"
N_REQUESTS, NEW_TOKENS = 12, 64
ENGINE = dict(max_batch=8, max_len=512, page_size=16, prefill_chunk=16,
              slab_k=8)

# datasheet figures (SXM parts, dense rates): bytes/s of device memory and
# operations/s by input type (f32 outside the tensor cores, as the kernels
# compute)
CARDS = {"H100": {"bytes_s": 3.35e12, "bf16": 989e12, "f32": 67e12},
         "H200": {"bytes_s": 4.8e12, "bf16": 989e12, "f32": 67e12}}

REPLACES = {
    "bspmm": ("src/repro_torch/csrc/bspmm.cu",
              "src/repro/kernels/bspmm.py:37"),
    "fused_glu_split": ("src/repro_torch/csrc/bspmm.cu",
                        "src/repro/kernels/bspmm.py:95"),
    "fused_glu_joint": ("src/repro_torch/csrc/bspmm.cu",
                        "src/repro/kernels/bspmm.py:124"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:53"),
    "bspmm_t": ("src/repro_torch/csrc/bspmm_t.cu",
                "src/repro/kernels/bspmm_t.py:46"),
}
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEP_SIZE = 12, 128, 8, 4


def emit(**obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ timing
class Timer:
    """Median device time of one call, each rep after an L2 flush: on the
    served path every layer's weights arrive cold from device memory. The
    flush writes the 256 MB buffer FLUSHES times (~0.34 ms of device
    work), so the card is still busy while the host runs the wrapper and
    enqueues the kernel: the events then bracket the kernel, not the
    host (a single pass did not hide a slow host's wrapper time)."""

    FLUSHES = 4

    def __init__(self, torch, reps=25):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device=DEVICE)
        for _ in range(50):      # a busy card first: clocks up before the
            self.flush.zero_()   # first case is timed
        torch.cuda.synchronize()

    def flush_l2(self):
        for _ in range(self.FLUSHES):
            self.flush.zero_()

    def ms(self, fn):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush_l2()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled_ms(torch, timer, fn, name, reps=25):
    """The profiler's mean device duration of the kernels whose name
    holds ``name`` (``bsp::`` for the shared block-sparse loops,
    ``paged_decode`` for paged decode) in ``fn``, each call after the
    same L2 flush as ``Timer``; "not measured" when the profiler records
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush_l2()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in evs)
    if not n:
        return "not measured"
    return sum(e.self_device_time_total for e in evs) / n / 1e3


def bound_ms(card, nbytes, ops, dtype_key):
    tb = nbytes / card["bytes_s"]
    to = ops / card[dtype_key]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ulp_tol(torch, ref, dtype):
    """Tolerance on max |kernel - plain|: f32 about 1e-4 of the output's
    magnitude (the two sum in different orders); bf16 two bf16 ulps of
    the output's magnitude (each side rounds its f32 result once, and
    the plain fused GLU also rounds gate and up before the activation)."""
    mag = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * mag
    return 2.0 * 2.0 ** (math.floor(math.log2(max(mag, 1e-30))) - 7)


# ------------------------------------------------------------------ phases
def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    # plain f32 products must not run in TF32 for the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit(phase="env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         device=torch.cuda.get_device_name(0),
         python=sys.version.split()[0])
    name = torch.cuda.get_device_name(0)
    for key, card in CARDS.items():
        if key in name:
            return card
    raise SmokeFailure(f"no datasheet figures for {name!r}")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    paths = build.build_all()
    emit(phase="build", seconds=time.monotonic() - t0,
         libraries={k: os.path.relpath(str(v), ROOT)
                    for k, v in paths.items()})


def phase_model(torch, cfg):
    """Seeded f32 weights on the card, the one-shot prune at 0.8 of
    repro/launch/serve.py (dense_last not applied), then the packed
    (split), packed joint and pruned-dense serving params."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    from repro_torch.models import registry
    from repro_torch.serving import export
    t0 = time.monotonic()
    params = registry.init_params(cfg, SEED, device=DEVICE)
    spec = dataclasses.replace(cfg.blast, s_init=0.8, s_max=0.8)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    packed = export.pack_params(cfg, params, masks, unbalanced="raise")
    jmasks = dict(masks)
    jmasks["layers/mlp/w_up"] = masks["layers/mlp/w_gate"]
    joint = export.pack_params(cfg, params, jmasks, unbalanced="raise")
    dense = export.prune_params(cfg, params, masks)
    del params, masks, jmasks
    mlp, jmlp = packed["layers"]["mlp"], joint["layers"]["mlp"]
    check(not mlp["w_gate"].joint and jmlp["w_gate"].joint
          and jmlp["w_up"].joint, "joint marking is wrong")
    emit(phase="model", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         sparsity=0.8, seconds=time.monotonic() - t0,
         nnz={k: mlp[k].nnz for k in ("w_gate", "w_up", "w_down")},
         kb={k: mlp[k].kb for k in ("w_gate", "w_up", "w_down")},
         memory_packed=export.memory_report(cfg, packed),
         memory_dense=export.memory_report(cfg, dense),
         memory_packed_joint=export.memory_report(cfg, joint))
    return packed, joint, dense


def phase_kernels(torch, card, packed, joint):
    """Each kernel against its plain version on the card, at the serving
    shapes: layer 0's real packed weights, M in {5, 8, 128} rows
    (decode lanes and a prefill chunk of 8 lanes x 16) for the MLP
    kernels, B=8 lanes and R in {1, 4, 16, 32} pages for decode, in bf16
    and f32; and bspmm at packed fine-tuning's M = 1024 rows on the gate
    shape X (1024, 2048) -> (1024, 8192) and the down shape. Each bspmm
    and fused-GLU line (split and joint) names the kernel and split it
    took (``plan``) and each paged line its CTAs per (lane, kv head)
    (``splits``); their bf16 lines also give the profiler's kernel
    duration beside the event time.
    Returns per-kernel summaries at the decode shape (M=8 bf16, R=16
    bf16: the largest read bucket of the served traffic)."""
    import torch.nn.functional as F
    from repro_torch.core.packing import PackedBCSC, unpack
    from repro_torch.kernels import bspmm as kb, ops, split_plan
    from repro_torch.kernels import paged_attention as pa
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    n_sm = kb.n_sms(torch.cuda.current_device())
    summary = {}

    def cast(p, dt):
        return PackedBCSC(p.blocks.to(dt).contiguous(), p.idx, p.kb, p.joint)

    mlp0 = {k: v.layer(0) for k, v in packed["layers"]["mlp"].items()}
    jmlp0 = {k: v.layer(0) for k, v in joint["layers"]["mlp"].items()}
    dense_down = unpack(mlp0["w_down"])
    dense_gu = torch.cat([unpack(mlp0["w_gate"]),
                          unpack(mlp0["w_up"])], dim=1)
    dense_gu_j = torch.cat([unpack(jmlp0["w_gate"]),
                            unpack(jmlp0["w_up"])], dim=1)

    def record(name, dt, shape, got, want, t_k, t_p, t_l, nbytes, ops_,
               **extra):
        err = float((got.float() - want.float()).abs().max())
        tol = ulp_tol(torch, want, dt)
        key = "bf16" if dt == torch.bfloat16 else "f32"
        b_ms, b_by = bound_ms(card, nbytes, ops_, key)
        emit(phase="kernel", name=name, dtype=key, shape=shape,
             max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p,
             library_ms=t_l, bound_ms=b_ms, bound_by=b_by, **extra)
        check(err <= tol and math.isfinite(err),
              f"{name} {key} {shape}: max abs err {err} > tol {tol}")
        return dict(max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p,
                    library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                    shape=shape, dtype=key, **extra)

    for dt in (torch.bfloat16, torch.float32):
        es = 2 if dt == torch.bfloat16 else 4
        down = cast(mlp0["w_down"], dt)
        gate, up = cast(mlp0["w_gate"], dt), cast(mlp0["w_up"], dt)
        jgate, jup = cast(jmlp0["w_gate"], dt), cast(jmlp0["w_up"], dt)
        wd, wgu, wgu_j = (dense_down.to(dt), dense_gu.to(dt),
                          dense_gu_j.to(dt))
        for m in (5, 8, 128):
            h = torch.randn(m, down.kb * down.b_in, generator=gen,
                            device=DEVICE).to(dt)
            x = torch.randn(m, gate.kb * gate.b_in, generator=gen,
                            device=DEVICE).to(dt)
            n_dn = down.nb * down.b_out
            n_ff = gate.nb * gate.b_out
            blk = lambda p: p.blocks.numel() * es + p.idx.numel() * 4  # noqa
            rows = {
                "bspmm": (
                    lambda: kb.bspmm(h, down), lambda: ops.bspmm_plain(h, down),
                    lambda: torch.matmul(h, wd),
                    h.numel() * es + blk(down) + m * n_dn * es,
                    ops.flops_bspmm(m, down)),
                "fused_glu_split": (
                    lambda: kb.fused_glu(x, gate, up),
                    lambda: ops.fused_glu_plain(x, gate, up),
                    lambda: torch.matmul(x, wgu),
                    x.numel() * es + blk(gate) + blk(up) + m * n_ff * es,
                    ops.flops_bspmm(m, gate) + ops.flops_bspmm(m, up)),
                "fused_glu_joint": (
                    lambda: kb.fused_glu(x, jgate, jup),
                    lambda: ops.fused_glu_plain(x, jgate, jup),
                    lambda: torch.matmul(x, wgu_j),
                    x.numel() * es + jgate.blocks.numel() * es * 2
                    + jgate.idx.numel() * 4 + m * n_ff * es,
                    ops.flops_bspmm(m, jgate) * 2),
            }
            plans = {"bspmm": kb.launch_plan(h, down),
                     "fused_glu_split": kb.launch_plan(x, gate, up),
                     "fused_glu_joint": kb.launch_plan(x, jgate, jup)}
            for name, (k_fn, p_fn, l_fn, nbytes, ops_) in rows.items():
                extra = {}
                if name in plans:
                    extra["plan"] = plans[name].describe()
                    if dt == torch.bfloat16:
                        extra["profiler_ms"] = profiled_ms(torch, timer,
                                                           k_fn, "bsp::")
                res = record(name, dt, [m], k_fn(), p_fn(), timer.ms(k_fn),
                             timer.ms(p_fn), timer.ms(l_fn), nbytes, ops_,
                             **extra)
                if dt == torch.bfloat16 and m == 8:
                    summary[name] = res
        # packed fine-tuning's forward: M = 1024 rows (8 x 128 tokens)
        for shape, p in (("gate", gate), ("down", down)):
            m = 1024
            x = torch.randn(m, p.kb * p.b_in, generator=gen,
                            device=DEVICE).to(dt)
            wdense = unpack(p)
            k_fn = lambda: kb.bspmm(x, p)  # noqa: E731
            p_fn = lambda: ops.bspmm_plain(x, p)  # noqa: E731
            l_fn = lambda: torch.matmul(x, wdense)  # noqa: E731
            nbytes = (x.numel() * es + p.blocks.numel() * es
                      + p.idx.numel() * 4 + m * p.nb * p.b_out * es)
            record("bspmm", dt, [m, shape], k_fn(), p_fn(), timer.ms(k_fn),
                   timer.ms(p_fn), timer.ms(l_fn), nbytes,
                   ops.flops_bspmm(m, p),
                   plan=kb.launch_plan(x, p).describe())
        # decode: B=8 lanes, 8 kv heads x 4 query heads of 64, pages of 16,
        # a pool of 256 pages per layer (the served engine's)
        b, kvh, g, hd, ps, n_pages = 8, 8, 4, 64, 16, 256
        pk_ = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                          device=DEVICE).to(dt)
        pv_ = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                          device=DEVICE).to(dt)
        table = torch.randperm(n_pages, generator=gen, device=DEVICE)[
            :b * 32].reshape(b, 32).to(torch.int32)
        for r in (1, 4, 16, 32):
            q4 = torch.randn(b, kvh, g, hd, generator=gen,
                             device=DEVICE).to(dt)
            bt = table[:, :r]                       # strided, as served
            lens = torch.randint(1, r * ps + 1, (b,), generator=gen,
                                 device=DEVICE)
            slots = torch.arange(r * ps, device=DEVICE)[None]
            bias = torch.where(slots < lens[:, None], 0.0,
                               pa.NEG_INF).float().contiguous()
            valid = int(lens.sum())
            k_fn = lambda: pa.paged_flash_decode(  # noqa: E731
                q4, pk_, pv_, bt, bias, scale=0.125)
            p_fn = lambda: pa.paged_flash_decode_plain(  # noqa: E731
                q4, pk_, pv_, bt, bias, scale=0.125)
            # yardstick: SDPA over the pre-gathered pages (gather untimed)
            gk = pk_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
            gv = pv_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
            qs = q4.reshape(b, kvh * g, 1, hd)
            am = (slots < lens[:, None])[:, None, None, :]
            l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, gk, gv, attn_mask=am, scale=0.125, enable_gqa=True)
            nbytes = (q4.numel() * es + valid * kvh * hd * es * 2
                      + bt.numel() * 4 + bias.numel() * 4 + q4.numel() * 4)
            ops_ = 4 * valid * kvh * g * hd
            extra = {"splits": split_plan.decode_splits(b, kvh, r, n_sm)}
            if dt == torch.bfloat16:
                extra["profiler_ms"] = profiled_ms(torch, timer, k_fn,
                                                   "paged_decode")
            res = record("paged_flash_decode", dt, [b, r], k_fn(), p_fn(),
                         timer.ms(k_fn), timer.ms(p_fn), timer.ms(l_fn),
                         nbytes, ops_, **extra)
            if dt == torch.bfloat16 and r == 16:
                summary["paged_flash_decode"] = res
    return summary


def _counters():
    from repro_torch.kernels import bspmm as kb, bspmm_t as kt
    from repro_torch.kernels import paged_attention as pa
    return (kb.LAUNCHES, kt.LAUNCHES, pa.LAUNCHES)


def _reset_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


def _read_counts():
    return {k: v for d in _counters() for k, v in d.items()}


def _serve(cfg, params, prompts, new_tokens):
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, device=DEVICE, **ENGINE)
    uids = [eng.submit(p, new_tokens) for p in prompts]
    t0 = time.monotonic()
    res = eng.run()
    wall = time.monotonic() - t0
    return eng, [res[u] for u in uids], wall


def phase_serve(torch, cfg, name, params, prompts, new_tokens, must_launch,
                must_not):
    """One serving run, launch counters reset just before and read just
    after."""
    _reset_counts()
    eng, results, wall = _serve(cfg, params, prompts, new_tokens)
    counts = _read_counts()
    st = eng.stats
    done = sum(r.ok and r.generated.size == new_tokens for r in results)
    emit(phase="serve", run=name, submitted=len(prompts), completed=done,
         completed_equals_submitted=done == len(prompts),
         tok_per_s=st["tok_per_s"], ttft_p50_s=st["ttft_p50_s"],
         ttft_p95_s=st["ttft_p95_s"], decode_slabs=st["decode_slabs"],
         prefill_chunks=st["prefill_chunks"],
         generated_tokens=st["generated_tokens"],
         peak_kv_bytes=st["peak_kv_bytes"], wall_s=wall,
         launches=counts)
    check(done == len(prompts), f"{name}: {done}/{len(prompts)} completed")
    for r in results:
        g = r.generated
        check(bool(((g >= 0) & (g < cfg.vocab_size)).all()),
              f"{name}: token outside the vocabulary")
    for k in must_launch:
        check(counts[k] > 0, f"{name}: kernel {k} never launched")
    for k in must_not:
        check(counts[k] == 0, f"{name}: kernel {k} launched unexpectedly")
    return results, counts


def _last_logits(torch, cfg, params, prompt):
    """Next-token logits after ``prompt``: one single-lane prefill chunk
    through the same model functions the engine calls."""
    from repro_torch.models import transformer
    ps = ENGINE["page_size"]
    pages = -(-len(prompt) // ps)
    cache = transformer.init_paged_cache(cfg, pages, ps, device=DEVICE)
    with torch.inference_mode():
        logits, _ = transformer.paged_prefill_chunk(
            cfg, params, cache,
            torch.as_tensor(prompt, device=DEVICE)[None], 0,
            torch.zeros(1, dtype=torch.int32, device=DEVICE),
            torch.arange(pages, dtype=torch.int32, device=DEVICE)[None],
            read_pages=pages)
    return logits[0, -1].float()


def _first_layers(tree, n):
    """The params of the model's first ``n`` layers (views)."""
    from repro_torch.core.packing import PackedBCSC
    out = {}
    for k, v in tree.items():
        if k != "layers":
            out[k] = v
            continue
        out[k] = {}
        for name, sub in v.items():
            if isinstance(sub, dict):
                out[k][name] = {
                    a: (PackedBCSC(b.blocks[:n], b.idx[:n], b.kb, b.joint)
                        if isinstance(b, PackedBCSC) else b[:n])
                    for a, b in sub.items()}
            else:
                out[k][name] = sub[:n]
    return out


def _mlp_inputs(torch, cfg, params, prompts):
    """The hidden state entering every layer's MLP, per prompt, recorded
    from a prefill through ``params`` (one entry per prompt and layer)."""
    from repro_torch.models import transformer
    seen = []
    forward = transformer.mlp_forward

    def recording(cfg_, p, x):
        seen.append(x.clone())
        return forward(cfg_, p, x)

    transformer.mlp_forward = recording
    try:
        for p in prompts:
            _last_logits(torch, cfg, params, p)
    finally:
        transformer.mlp_forward = forward
    return seen


def phase_e2e(torch, cfg, packed, dense, prompts):
    """Packed (kernels) against pruned-dense (plain torch.matmul MLP) on
    the served prompts.

    The checks:

    * every layer, teacher-forced: on the hidden states the dense model
      feeds each of the 16 MLPs, the packed MLP (fused GLU + BSpMM
      kernels) must match the dense MLP within 2**-5 of the output's
      magnitude (4 bf16 ulps at the top: the dense path rounds gate, up,
      the activation and the product to bf16, the kernels only h);
    * end to end through the engine on the model's first 2 layers (same
      weights): next-token logits within 2**-5 of their magnitude, and
      the first generated token equal wherever the dense logits' top-2
      margin exceeds twice that tolerance;
    * at full depth, the next-token logits of the first 4 prompts within
      2**-5 of their magnitude (printed beside dense bf16 vs dense f32).
      With the reference's init, whose attention weights were 8-16x too
      large, the random network was chaotic in depth and this could not
      hold; the port's init uses the true fan-in (models/params.py)."""
    from repro_torch.models import transformer
    hs = _mlp_inputs(torch, cfg, dense, prompts)
    worst, n = 0.0, cfg.num_layers
    with torch.inference_mode():
        for i, h in enumerate(hs):
            lp = transformer._layer_view(packed["layers"], i % n)["mlp"]
            ld = transformer._layer_view(dense["layers"], i % n)["mlp"]
            yp = transformer.mlp_forward(cfg, lp, h).float()
            yd = transformer.mlp_forward(cfg, ld, h).float()
            check(bool(torch.isfinite(yp).all()), "non-finite packed MLP")
            tol = 2.0 ** -5 * float(yd.abs().max())
            err = float((yp - yd).abs().max())
            worst = max(worst, err / tol)
            check(err <= tol, f"layer {i % n} MLP: packed vs dense differ "
                              f"by {err} > {tol}")
    emit(phase="e2e_layers", layers=n, prompts=len(prompts),
         checked=len(hs), max_err_over_tol=worst, tol_fraction=2.0 ** -5)

    depth = 2
    cfg2 = dataclasses.replace(cfg, num_layers=depth)
    p2, d2 = _first_layers(packed, depth), _first_layers(dense, depth)
    _reset_counts()
    _, packed_res, _ = _serve(cfg2, p2, prompts, 1)
    counts = _read_counts()
    _reset_counts()
    _, dense_res, _ = _serve(cfg2, d2, prompts, 1)
    dense_counts = _read_counts()
    check(counts["bspmm"] > 0 and counts["fused_glu_split"] > 0,
          "the packed prefix run launched no BSpMM kernel")
    check(dense_counts["bspmm"] == 0 and dense_counts["fused_glu_split"] == 0,
          "the dense prefix run launched a BSpMM kernel")
    worst, scale, exempt, compared = 0.0, 0.0, 0, 0
    for p, pr, dr in zip(prompts, packed_res, dense_res):
        lp = _last_logits(torch, cfg2, p2, p)
        ld = _last_logits(torch, cfg2, d2, p)
        check(bool(torch.isfinite(lp).all()), "non-finite packed logits")
        mag = float(ld.abs().max())
        tol = 2.0 ** -5 * mag
        err = float((lp - ld).abs().max())
        worst, scale = max(worst, err / tol), max(scale, mag)
        check(err <= tol, f"packed vs dense logits differ by {err} > {tol}")
        top2 = torch.topk(ld, 2).values
        if float(top2[0] - top2[1]) > 2 * tol:
            compared += 1
            check(int(pr.generated[0]) == int(dr.generated[0]),
                  "first generated token differs outside a near-tie")
        else:
            exempt += 1
    full, full_mag = 0.0, 0.0
    for p in prompts[:4]:
        ld = _last_logits(torch, cfg, dense, p)
        full = max(full, float((_last_logits(torch, cfg, packed, p)
                                - ld).abs().max()))
        full_mag = max(full_mag, float(ld.abs().max()))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    chaos = max(float((_last_logits(torch, cfg, dense, p)
                       - _last_logits(torch, cfg32, dense, p)).abs().max())
                for p in prompts[:4])
    emit(phase="e2e_logits", depth=depth, requests=len(prompts),
         max_err_over_tol=worst, logit_magnitude=scale,
         tol_fraction=2.0 ** -5, first_tokens_compared=compared,
         exempt_near_ties=exempt, packed_launches=counts,
         dense_launches=dense_counts,
         full_depth_packed_vs_dense_max_abs=full,
         full_depth_logit_magnitude=full_mag,
         full_depth_dense_bf16_vs_f32_max_abs=chaos)
    check(full <= 2.0 ** -5 * full_mag,
          f"full-depth packed vs dense logits differ by {full} at "
          f"magnitude {full_mag}")


def phase_profile(torch, cfg, packed, prompts):
    """Where a decode step's time goes: two pure-decode slabs of 8 lanes
    under torch.profiler (the admission, prefill and first slab run
    before the window). Device time is the sum of the GPU kernels' own
    time; the busy share divides it by the window's wall time, which the
    profiler's CPU-side tracing lengthens. Reported as not measured when
    the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Engine
    k = ENGINE["slab_k"]
    eng = Engine(cfg, packed, device=DEVICE, **ENGINE)
    for p in prompts[:ENGINE["max_batch"]]:
        eng.submit(p, 1 + 3 * k)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit(phase="profile", decode_steps=2 * k, lanes=ENGINE["max_batch"],
         wall_ms=wall_ms, step_ms=wall_ms / (2 * k),
         device_ms=dev_ms if dev_ms > 0 else "not measured",
         device_busy_share=dev_ms / wall_ms if dev_ms > 0
         else "not measured",
         top=[{"kernel": e.key[:90], "count": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])


def phase_kernels_t(torch, card, packed):
    """The transposed BSpMM against its plain version on the card, at the
    training shapes: dY (M, 8192) -> dX (M, 2048) through layer 0's
    packed gate (Kb = 16, 256 visits) and dY (M, 2048) -> dX (M, 8192)
    through its packed down (Kb = 64, 208 visits), M in {5, 128, 1024},
    bf16 and f32; then, at M = 128 on the down shape, a balanced mask
    with block-rows 0 and 5 never visited and a global-selection mask
    that packs zero padding at idx 0. Library yardstick: torch.matmul of
    dY by the unpacked pruned weight's transpose. Returns the summary at
    M = 1024, bf16, gate shape (8 sequences of 128 tokens)."""
    from repro_torch.core import topk
    from repro_torch.core.packing import PackedBCSC, pack, unpack
    from repro_torch.core.prune_grow import BlastSpec, initial_mask
    from repro_torch.kernels import bspmm_t as kt, ops
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    mlp0 = {k: v.layer(0) for k, v in packed["layers"]["mlp"].items()}
    w = torch.randn(8192, 2048, generator=gen, device=DEVICE)
    hole = w.clone()
    hole[:128] = 0.0
    hole[5 * 128:6 * 128] = 0.0
    spec = BlastSpec(b_in=128, b_out=128, s_init=0.8)
    norms = topk.block_norms(w, 128, 128)
    glob = topk.topk_mask_global(norms, norms.numel() // 5)
    extra = {}
    for name, (wt, m) in {"down_empty_rows": (hole, initial_mask(spec, hole)),
                          "down_global": (w, glob)}.items():
        extra[name] = (pack(topk.apply_block_mask(wt, m, 128, 128), m, 128,
                            128), int(m.sum()))
    visited = set(extra["down_empty_rows"][0].idx.reshape(-1).tolist())
    check(not {0, 5} & visited, "the empty-rows mask visits rows 0 or 5")
    check(bool((extra["down_global"][0].idx == 0).sum()
               > extra["down_global"][0].nb), "the global mask is not padded")
    cases = [("gate", mlp0["w_gate"], None, m) for m in (5, 128, 1024)]
    cases += [("down", mlp0["w_down"], None, m) for m in (5, 128, 1024)]
    cases += [(k, p, n, 128) for k, (p, n) in extra.items()]
    summary = None
    for dt in (torch.bfloat16, torch.float32):
        es = 2 if dt == torch.bfloat16 else 4
        key = "bf16" if dt == torch.bfloat16 else "f32"
        for name, p0, kept, m in cases:
            p = PackedBCSC(p0.blocks.to(dt).contiguous(), p0.idx, p0.kb)
            kept = p.nb * p.nnz if kept is None else kept
            plan = kt.device_plan(p.idx, p.kb)
            wt_dense = unpack(p).t()
            dy = torch.randn(m, p.nb * p.b_out, generator=gen,
                             device=DEVICE).to(dt)
            lp = kt.launch_plan(dy, p, plan)
            k_fn = lambda: ops.bspmm_t(dy, p, plan)  # noqa: E731
            p_fn = lambda: ops.bspmm_t_plain(dy, p)  # noqa: E731
            l_fn = lambda: torch.matmul(dy, wt_dense)  # noqa: E731
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ulp_tol(torch, want, dt)
            nbytes = (dy.numel() * es + p.blocks.numel() * es
                      + plan.visits.numel() * 4
                      + plan.bounds[lp.splits - 1].numel() * 4
                      + m * p.kb * p.b_in * es)
            ops_ = 2 * m * kept * p.b_in * p.b_out
            b_ms, b_by = bound_ms(card, nbytes, ops_, key)
            row = dict(max_abs_err=err, tol=tol, ms=timer.ms(k_fn),
                       plain_ms=timer.ms(p_fn), library_ms=timer.ms(l_fn),
                       bound_ms=b_ms, bound_by=b_by, shape=[m, name],
                       dtype=key, plan=lp.describe(),
                       visits_max=plan.max_len,
                       rows_never_visited=int((plan.lengths == 0).sum()))
            emit(phase="kernel", name="bspmm_t", **row)
            check(err <= tol and math.isfinite(err),
                  f"bspmm_t {key} {name} M={m}: max abs err {err} > {tol}")
            if name == "down_empty_rows":
                check(not bool(got.reshape(m, p.kb, 128)[:, [0, 5]].any()),
                      "bspmm_t wrote non-zeros into never-visited rows")
            if key == "bf16" and name == "gate" and m == 1024:
                summary = row
    return summary


def _record_steps(train_loop):
    """Wrap the loop's step factory so every step's (step, new masks) is
    kept; returns (list, restore)."""
    seen = []
    make = train_loop.step_mod.make_train_step

    def recording(*a, **kw):
        fn = make(*a, **kw)

        def step(state, batch):
            new, metrics = fn(state, batch)
            seen.append((state.step, new.masks))
            return new, metrics
        return step

    train_loop.step_mod.make_train_step = recording
    return seen, lambda: setattr(train_loop.step_mod, "make_train_step",
                                 make)


def phase_train(torch, cfg):
    """12 steps of the BLaST trainer on full-width, full-depth
    Llama-3.2-1B (f32 params, bf16 compute, remat per layer): masked
    dense with in-step prune-and-grow every 4 steps toward s = 0.8 by
    step 12 (launch/train.py's overrides of total_steps, its warmup and
    guard). The peak learning rate is AdamWConfig's default, 3e-4:
    launch/train.py's CLI default of 3e-3 is sized for the smoke configs
    and makes a full-width 1B model's loss oscillate upward."""
    from repro_torch.core import sparse_mlp as sm, topk
    from repro_torch.core.schedule import keep_count, sparsity_at
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.training import train_loop
    cfg = dataclasses.replace(cfg, blast=dataclasses.replace(
        cfg.blast, total_steps=TRAIN_STEPS, step_size=TRAIN_STEP_SIZE))
    src = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                            warmup_steps=max(TRAIN_STEPS // 20, 5))
    loop = train_loop.TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _record_steps(train_loop)
    _reset_counts()
    t0 = time.monotonic()
    try:
        state, hist = train_loop.train(cfg, opt, src, loop, device=DEVICE,
                                       seed=SEED, log_fn=lambda m: None)
    finally:
        restore()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = [h for h in hist if "event" not in h]
    losses = [h["loss"] for h in steps]
    step_s = [h["sec_per_step"] for h in steps[1:]]
    med = statistics.median(step_s)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    emit(phase="train", config=cfg.name, layers=cfg.num_layers,
         steps=TRAIN_STEPS, tokens_per_step=tokens,
         params=registry.count_params(cfg), losses=losses,
         grad_norms=[h["grad_norm"] for h in steps],
         sparsity_final=float(steps[-1]["sparsity"]),
         anomalies=sum(int(h["anomaly"]) for h in steps),
         first_step_s=steps[0]["sec_per_step"], median_step_ms=med * 1e3,
         tokens_per_s=tokens / med, wall_s=wall,
         max_memory_allocated_bytes=peak, launches=counts)
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(not any(counts.values()), f"training launched kernels: {counts}")
    spec, flags = cfg.blast, registry.dense_layer_flags(cfg)
    refreshes = []
    for step, masks in seen:
        if step % TRAIN_STEP_SIZE:
            continue
        s = sparsity_at(step, s_init=spec.s_init, s_max=spec.s_max,
                        total_steps=spec.total_steps, decay=spec.decay)
        kept = {}
        for path, m in masks.items():
            per_col = m.sum(dim=-2).cpu()                  # (L, Nb)
            want = keep_count(s, m.shape[-2])
            check(bool((per_col[~flags] == want).all()),
                  f"step {step} {path}: kept per column "
                  f"{per_col[~flags].unique().tolist()} != {want}")
            check(bool(m[flags.to(m.device)].all()),
                  f"{path}: a dense_last layer pruned")
            kept[path.split("/")[-1]] = want
        refreshes.append({"step": step, "sparsity": s, "kept_per_col": kept})
    check(len(refreshes) == 3, f"refreshes seen: {refreshes}")
    for path, mask in state.masks.items():
        bi, bo = sm.block_dims_for(spec, path)
        pruned = ~topk.expand_mask(mask, bi, bo)
        for tree, name in ((state.params, "params"),
                           (state.opt_state["m"], "m"),
                           (state.opt_state["v"], "v")):
            check(not bool(sm.get_path(tree, path)[pruned].any()),
                  f"{path}: pruned blocks not zero in {name}")
    emit(phase="train_refreshes", refreshes=refreshes)
    return cfg, opt, src, state


def phase_train_profile(torch, cfg, opt, src, state):
    """Where a training step's time goes: two more steps of the trained
    state under torch.profiler, a refresh step (12) and a plain one (13).
    Device time is the sum of the GPU kernels' own time; the busy share
    divides it by the step's wall time, which the profiler's CPU-side
    tracing lengthens. GEMM kernels are those whose name says gemm,
    xmma, cutlass or nvjet (cuBLAS's); the rest are elementwise,
    reductions and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import step as step_mod
    fn = step_mod.make_train_step(cfg, opt)
    for i in range(2):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in src.batch(state.step).items()}
        refresh = state.step % cfg.blast.step_size == 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, _ = fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        gemm_ms = sum(e.self_device_time_total for e in kern if any(
            w in e.key.lower()
            for w in ("gemm", "xmma", "cutlass", "nvjet"))) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
        emit(phase="train_profile", step=state.step - 1, refresh=refresh,
             wall_ms=wall_ms,
             device_ms=dev_ms if dev_ms > 0 else "not measured",
             gemm_device_ms=gemm_ms if dev_ms > 0 else "not measured",
             device_busy_share=dev_ms / wall_ms if dev_ms > 0
             else "not measured",
             kernel_launches=sum(e.count for e in kern),
             top=[{"kernel": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top])


def _train_mlp_inputs(torch, cfg, state, tokens):
    """The hidden state entering every layer's MLP in a no-grad forward
    of the trained model (one (M, d) matrix per layer)."""
    from repro_torch.models import transformer
    seen = []
    forward = transformer.mlp_forward

    def recording(cfg_, p, x, masks=None):
        seen.append(x.reshape(-1, x.shape[-1]).clone())
        return forward(cfg_, p, x, masks)

    transformer.mlp_forward = recording
    try:
        with torch.no_grad():
            transformer.forward(cfg, state.params, tokens,
                                masks=state.masks)
    finally:
        transformer.mlp_forward = forward
    return seen


def phase_finetune_packed(torch, cfg, state, batch):
    """The paper's fine-tuning stage at fixed masks, against the trainer.
    Every layer's gate, up and down are packed with that layer's trained
    mask; on that layer's MLP input from one batch (8 x 128 tokens), the
    gradient of sum(Y * C) (C seeded) through three make_bspmm_trainable
    products (forward bspmm, dX bspmm_t, dBlocks gathered) is held
    against the gradient through the trainer's masked-dense STE GLU: dX
    everywhere, dW at every kept block. f32 within 1e-4 and bf16 within
    2**-5 of each gradient's magnitude (bf16 rounds gate, up, the
    activation, the product and each partial gradient on both sides,
    from f32 sums taken in other orders). Counters reset before each
    dtype's 16 layers and read after: bspmm and bspmm_t 48 each."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.packing import pack
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    hs = _train_mlp_inputs(torch, cfg, state,
                           torch.as_tensor(batch["tokens"], device=DEVICE))
    check(len(hs) == cfg.num_layers, f"{len(hs)} MLP inputs recorded")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    leaves = ("w_gate", "w_up", "w_down")
    spec = cfg.blast
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        key = "bf16" if dt == torch.bfloat16 else "f32"
        frac = 1e-4 if dt == torch.float32 else 2.0 ** -5
        worst, nnz_l = {"dx": 0.0, "dw": 0.0}, {}
        _reset_counts()
        for i, h in enumerate(hs):
            p_l = transformer._layer_view(state.params["layers"], i)["mlp"]
            m_l = transformer._layer_masks(
                {k: v[i] for k, v in state.masks.items()}, "layers")
            x = h.to(dt).contiguous()
            c = torch.randn(x.shape, generator=gen, device=DEVICE)
            # the trainer's masked-dense STE GLU
            xd = x.clone().requires_grad_()
            ws = [p_l[k].detach().requires_grad_() for k in leaves]
            y = sm.glu_mlp(xd, *ws, act=cfg.mlp_act, masks=m_l, spec=spec)
            dense = torch.autograd.grad((y.float() * c).sum(), [xd, *ws])
            # three trainable packed products
            fs, blocks = [], []
            for k, w in zip(leaves, ws):
                bi, bo = sm.block_dims_for(spec, "layers/mlp/" + k)
                pk = pack(w.detach().to(dt), m_l[k], bi, bo)
                fs.append((ops.make_bspmm_trainable(pk.idx, pk.kb), pk))
                blocks.append(pk.blocks.requires_grad_())
                nnz_l.setdefault(k, []).append(pk.nnz)
            xp = x.clone().requires_grad_()
            hg = fs[0][0](xp, blocks[0])
            hu = fs[1][0](xp, blocks[1])
            yp = fs[2][0](sm.act_fn(cfg.mlp_act)(hg) * hu, blocks[2])
            packed = torch.autograd.grad((yp.float() * c).sum(),
                                         [xp, *blocks])
            checks = [("dx", packed[0], dense[0])]
            for (_, pk), db, dw in zip(fs, packed[1:], dense[1:]):
                nb, nnz, bi, bo = pk.blocks.shape
                dwb = dw.reshape(pk.kb, bi, nb, bo).permute(2, 0, 1, 3)
                cols = torch.arange(nb, device=DEVICE)[:, None]
                checks.append(("dw", db, dwb[cols, pk.idx.long()]))
            for what, got, want in checks:
                tol = frac * float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                check(math.isfinite(err) and err <= tol,
                      f"layer {i} {key} {what}: err {err} > tol {tol}")
                worst[what] = max(worst[what], err / tol)
        torch.cuda.synchronize()
        counts = _read_counts()
        n = 3 * cfg.num_layers
        check(counts["bspmm"] == n and counts["bspmm_t"] == n,
              f"{key}: bspmm {counts['bspmm']}, bspmm_t {counts['bspmm_t']}"
              f" launches, expected {n} each")
        check(not any(v for k, v in counts.items()
                      if k not in ("bspmm", "bspmm_t")),
              f"{key}: other kernels launched: {counts}")
        out[key] = counts
        emit(phase="finetune_packed", dtype=key, layers=len(hs),
             rows=int(hs[0].shape[0]), tol_fraction=frac,
             max_err_over_tol=worst, launches=counts,
             nnz_per_layer=nnz_l)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.paper_models import LLAMA32_1B
    import numpy as np

    card = phase_env(torch)
    phase_build()
    cfg = LLAMA32_1B
    packed, joint, dense = phase_model(torch, cfg)
    summary = phase_kernels(torch, card, packed, joint)

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),))
               .astype(np.int32) for n in rng.integers(32, 129,
                                                       size=N_REQUESTS)]
    _, counts = phase_serve(
        torch, cfg, "packed_split", packed, prompts, NEW_TOKENS,
        must_launch=("bspmm", "fused_glu_split", "paged_flash_decode"),
        must_not=("fused_glu_joint",))
    _, jcounts = phase_serve(
        torch, cfg, "packed_joint", joint, prompts[:4], 16,
        must_launch=("bspmm", "fused_glu_joint", "paged_flash_decode"),
        must_not=("fused_glu_split",))
    phase_e2e(torch, cfg, packed, dense, prompts)
    phase_profile(torch, cfg, packed, prompts)
    summary["bspmm_t"] = phase_kernels_t(torch, card, packed)
    del packed, joint, dense
    torch.cuda.empty_cache()

    tcfg, opt, src, state = phase_train(torch, cfg)
    ft = phase_finetune_packed(torch, tcfg, state, src.batch(TRAIN_STEPS))
    phase_train_profile(torch, tcfg, opt, src, state)

    kernels = []
    for name, (src, repl) in REPLACES.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=sum(c[name] for c in (counts, jcounts, *ft.values())),
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            matched=True, timed_shape=s["shape"], dtype=s["dtype"],
            **{k: s[k] for k in ("plan", "splits", "profiler_ms")
               if k in s}))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel never launched on a main path: {kernels}")
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
