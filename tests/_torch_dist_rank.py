"""One rank of the tensor-parallel serving scenarios
(``test_torch_dist_serving.py`` on the CPU, ``test_torch_dist_gpu.py`` on
the card) and of the sharded training ones (``test_torch_dist_train.py``,
``train_scenario`` below: a spec with a ``train`` entry;
``test_torch_dist_sp.py``, ``sp_scenario``; ``test_torch_dist_kd.py``,
``kd_scenario``; ``test_torch_dist_moe.py``, ``ep_scenario``;
``test_torch_dist_mlp2.py`` and ``test_torch_dist_audio_vlm.py``,
``tp_scenario``; ``test_torch_dist_ssm.py``, ``ssm_scenario``;
``test_torch_dist_data_serving.py``, ``dp_scenario``). Imports
torch and the port only, never JAX:

    python tests/_torch_dist_rank.py SPEC RANK

``SPEC`` is a pickle the test wrote: the gloo store directory, the world
size, the device and, per model, the port's config, the serving tree as
numpy arrays (packs as objects with ``blocks``/``idx``/``kb``/``joint``),
the traffic and the engine modes to run. The rank starts the process group from the ``file://``
store, takes its shard of every tree (``interop.to_torch_shard``), serves
the traffic through ``serve_loop.generate`` (greedy and sampled) and the
paged ``Engine`` (phased, mixed, phased with the prefix cache), recording
the engine's block tables and page accounting after every step, gathers
the full next-token logits of a few prompts, counts the kernel launches,
and pickles what it saw to ``rank<RANK>.pkl`` beside the spec.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MODES = {"phased": {}, "mixed": {"mixed": True},
         "prefix": {"prefix_cache": True}}


def snapshot(e) -> dict:
    """Host state that every rank, and the reference engine, must agree
    on after each step (the reference's engine has the same names)."""
    return {"lanes": list(e.active_lanes), "frontier": e.frontiers.tolist(),
            "bt": e.block_tables.tolist(), "free": e.pool.free_pages,
            "referenced": e.pool.referenced,
            "cached_idle": e.pool.cached_idle}


def drive(eng, prompts, new_tokens, max_steps=500):
    """Submit ``prompts``, step to the end; (streams, per-step
    snapshots)."""
    uids = [eng.submit(p, new_tokens) for p in prompts]
    out, snaps = {}, []
    for _ in range(max_steps):
        if not (len(eng.scheduler) or eng.active_lanes):
            break
        out.update((r.uid, r) for r in eng.step())
        snaps.append(snapshot(eng))
    else:
        raise RuntimeError(f"engine did not drain in {max_steps} steps")
    eng.check_lockstep()
    return [out[u].tokens for u in uids], snaps


def full_logits(cfg, params, prompt, dist, device):
    """The whole next-token logits row after ``prompt`` (one paged
    prefill chunk into an f32 pool, the vocab shards gathered; ``dist``
    None on one device)."""
    from repro_torch.models import transformer
    ps = 4
    pages = -(-len(prompt) // ps)
    cache = transformer.init_paged_cache(cfg, pages, ps, dtype=torch.float32,
                                         device=device, dist=dist)
    logits, _ = transformer.paged_prefill_chunk(
        cfg, params, cache, torch.as_tensor(prompt, device=device)[None], 0,
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.arange(pages, dtype=torch.int32, device=device)[None],
        read_pages=pages, dist=dist)
    last = logits[0, -1:]
    if dist is not None and dist.shards(cfg.vocab_size):
        last = dist.all_gather(last, dim=-1)
    return last[0].cpu().numpy()


def serve_model(m, dist, mesh, device) -> dict:
    from repro_torch import interop
    from repro_torch.serving import engine, export, serve_loop
    from repro_torch.kernels import bspmm, paged_attention
    counters = (bspmm.LAUNCHES, paged_attention.LAUNCHES)
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    cfg = m["cfg"]
    params = interop.to_torch_shard(m["params"], cfg, mesh, device=device)
    out = {"weight_bytes": export.memory_report(cfg, params)["bytes"]}
    with torch.inference_mode():
        out["loop"] = serve_loop.generate(
            cfg, params, m["equal"], max_new_tokens=m["new"],
            device=device, dist=dist)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        out["sampled"] = serve_loop.generate(
            cfg, params, m["equal"], max_new_tokens=m["new"],
            temperature=0.8, generator=gen, device=device, dist=dist)[0]
        out["logits"] = [full_logits(cfg, params, p, dist, device)
                         for p in m["logit_prompts"]]
    for mode in m["modes"]:
        kw = MODES[mode]
        eng = engine.Engine(cfg, params, device=device, dist=dist,
                            **m["engine"], **kw)
        prompts = m["prefix_prompts"] if mode == "prefix" else m["ragged"]
        streams, snaps = drive(eng, prompts, m["new"])
        out[mode] = {"streams": streams, "snaps": snaps,
                     "digest": eng.lockstep_digest,
                     "kv_bytes": sum(t.numel() * t.element_size()
                                     for t in eng.cache.values()),
                     "stats": {k: eng.stats[k] for k in (
                         "prefix_hits", "cow_copies",
                         "stalled_decode_steps", "mixed_steps")}}
    out["launches"] = {k: v for c in counters for k, v in c.items()}
    return out


def _np(tree):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _gathered(state, shardings, moments=False):
    """The logical params and masks (and ``moments``: AdamW's 'm' and
    'v') of a sharded state, as numpy."""
    from repro_torch.distributed import sharding
    out = {"params": _np(sharding.gather_tree(state.params,
                                              shardings.params)),
           "masks": _np(sharding.gather_tree(state.masks, shardings.masks))}
    if moments:
        out.update((k, _np(sharding.gather_tree(state.opt_state[k],
                                                shardings.params)))
                   for k in ("m", "v"))
    return out


def _host(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def train_scenario(t: dict, mesh, rank: int) -> dict:
    """The sharded training scenario on ``mesh``: from the logical state
    ``t["state"]`` (numpy), ``t["steps"]`` sharded steps on
    ``t["source"]``'s global batches (the logical params and masks after
    each), the guard's skips, the deferred step uncompressed, two
    int8-compressed deferred steps (each leaf's compressed-mean error
    against the f32 mean of gradient plus error feedback, beside its
    int8 bound; the logical state before and after each step and the
    compressed mean it should have applied), the unequal-scale
    reduction, and the
    elastic restart: ``train_loop.train`` checkpoints after two steps,
    then a sub-mesh restores it and takes the third step."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.checkpointing.checkpoint import Checkpointer
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.optim import adamw, compress
    from repro_torch.training import deferred, step as ts, train_loop
    cfg, opt, src = t["cfg"], t["opt"], t["source"]
    dist = DistContext(mesh)
    shd = sharding.state_shardings(cfg, mesh)
    logical = interop.train_state(t["state"], device="cpu")
    state0 = sharding.shard_state(logical, shd)
    out = {"local_bytes": sum(x.numel() * x.element_size() for x in
                              adamw.tree_leaves(state0.params))}

    def batch(i):
        """This rank's rows of global batch ``i`` (contiguous: one
        microbatch for the sharded step, the deferred step's whole
        rows)."""
        b = {k: torch.as_tensor(v) for k, v in src.batch(i).items()}
        return sharding.slice_batch(b, dist)

    # gather_from_model: the whole vector forward, this rank's slice of
    # the gradient backward
    x = (torch.arange(6.0) + 10 * dist.model_rank).requires_grad_()
    y = dist.gather_from_model(x, 0)
    (y * torch.arange(float(y.numel()))).sum().backward()
    out["gather"] = (y.detach().numpy(), x.grad.numpy(), dist.model_rank)

    step = ts.make_train_step(cfg, opt, dist=dist)
    st, runs = state0, []
    for i in range(t["steps"]):
        st, m = step(st, batch(i))
        runs.append(dict(metrics=_host(m), **_gathered(st, shd)))
    out["sharded"] = runs

    guard = []
    for k, v in (("force_skip", 1.0), ("grad_poison", float("nan"))):
        s1, m = step(state0, dict(batch(0), **{k: v}))
        guard.append(dict(what=k, metrics=_host(m), step=s1.step,
                          **_gathered(s1, shd)))
    out["guard"] = guard

    # deferred: the rank's contiguous rows, microbatched locally
    dstep = deferred.make_train_step_deferred(cfg, opt, dist, microbatches=2,
                                              compress_grads=False)
    st = dataclasses.replace(state0, opt_state=deferred.init_opt_state(
        cfg, state0.params, False))
    runs = []
    for i in range(t["steps"]):
        st, m = dstep(st, batch(i))
        runs.append(dict(metrics=_host(m), **_gathered(st, shd)))
    out["deferred"] = runs
    # deferred int8: two steps, the second with the first's error
    # feedback; per step each leaf's compressed mean against the f32
    # mean of g + ef, and the logical state before and after with the
    # compressed mean that the update should have applied
    cstep = deferred.make_train_step_deferred(cfg, opt, dist, microbatches=2,
                                              compress_grads=True)
    sc = dataclasses.replace(state0, opt_state=deferred.init_opt_state(
        cfg, state0.params, True))
    out["compress_err"], out["deferred_c"] = [], []
    for i in range(2):
        b = batch(i)
        _, _, g = ts.loss_and_grads(cfg, sc, b, dist, 2, over_data=False)
        ef = sc.opt_state["ef"]
        comp, new_ef = compress.compressed_psum(g, ef, dist)
        ge = adamw.tree_map(torch.add, g, ef)
        f32 = adamw.tree_map(lambda x: dist.mean_over_data(x.clone()), ge)
        scale = adamw.tree_map(
            lambda x: dist.max_over_data(x.abs().max() / 127.0), ge)
        out["compress_err"] += [
            (float((a - b).abs().max()), float(s) / 2)
            for a, b, s in zip(*(adamw.tree_leaves(x)
                                 for x in (comp, f32, scale)))]
        before = dict(step=sc.step, **_gathered(sc, shd, moments=True))
        sc, m = cstep(sc, b)
        out["deferred_c"].append(dict(
            metrics=_host(m), before=before,
            comp=_np(sharding.gather_tree(comp, shd.params)),
            ef_carried=all(bool(torch.equal(x, y)) for x, y in zip(
                adamw.tree_leaves(sc.opt_state["ef"]),
                adamw.tree_leaves(new_ef))),
            **_gathered(sc, shd, moments=True)))

    if dist.data_size == 2:
        big = torch.as_tensor([1.0]) if dist.data_rank == 0 else \
            torch.as_tensor([0.01])
        rng = torch.Generator().manual_seed(dist.data_rank)
        wide = torch.randn(1000, generator=rng) * (1.0 if dist.data_rank
                                                   == 0 else 0.01)
        out["unequal"] = [
            (x.numpy(), compress.reduce_leaf_int8(x, torch.zeros_like(x),
                                                  dist)[0].numpy())
            for x in (big, wide)]

        # elastic: two steps through the loop, a checkpoint, then the
        # third step on a (data 1, model 2) sub-mesh of ranks 0 and 1
        d = t["ckpt_dir"]
        loop = train_loop.TrainLoopConfig(total_steps=2, ckpt_dir=d,
                                          ckpt_every=2, log_every=1)
        st2, hist = train_loop.train(cfg, opt, src, loop, state=state0,
                                     device="cpu", dist=dist,
                                     log_fn=lambda e: None)
        out["loop_losses"] = [h["loss"] for h in hist if "loss" in h]
        full = sharding.gather_state(st2, shd)
        if rank == 0:
            Checkpointer(t["single_dir"]).save(2, full, blocking=True)
        sub = make_mesh((1, 2), ("data", "model"), ranks=[0, 1])
        if sub is not None:
            sdist = DistContext(sub)
            sshd = sharding.state_shardings(cfg, sub)
            tmpl = sharding.shard_state(logical, sshd)
            restored = Checkpointer(d, writer=False).restore_state(
                tmpl, shardings=sshd)
            b2 = {k: torch.as_tensor(v) for k, v in src.batch(2).items()}
            _, m = ts.make_train_step(cfg, opt, dist=sdist)(restored, b2)
            out["elastic"] = dict(step=restored.step, metrics=_host(m))
    return out


def count_collectives() -> dict:
    """Count every all-reduce, all-gather and reduce-scatter this process
    issues from now on (``torch.distributed``'s functions wrapped): {kind:
    calls}, which the caller clears."""
    import torch.distributed as tdist
    stats = {}

    def wrap(kind, fn):
        def call(*a, **kw):
            stats[kind] = stats.get(kind, 0) + 1
            return fn(*a, **kw)
        return call

    for kind, name in (("all_reduce", "all_reduce"),
                       ("all_gather", "all_gather"),
                       ("reduce_scatter", "reduce_scatter_single"),
                       ("reduce_scatter", "reduce_scatter_tensor")):
        if hasattr(tdist, name):
            setattr(tdist, name, wrap(kind, getattr(tdist, name)))
    return stats


def _stream_shapes():
    """Record the residual stream's shape at every ``transformer._block``
    call: (list of shapes, restore)."""
    from repro_torch.models import transformer
    block, shapes = transformer._block, []

    def recording(cfg, p, x, *a, **kw):
        shapes.append(tuple(x.shape))
        return block(cfg, p, x, *a, **kw)
    transformer._block = recording
    return shapes


def _pairs(dist) -> dict:
    """The sequence-parallel pairs on (1, 3, 2) shards (rank r's entries
    offset by 100 r): each forward and the gradient of a weighted sum
    (weights (r + 1) times 0, 1, 2, ...)."""
    r, tp = dist.model_rank, dist.tp
    out = {}
    for name, n in (("gather_from_seq", 3), ("reduce_scatter_to_seq",
                                             3 * tp),
                    ("scatter_to_seq", 3 * tp)):
        x = (torch.arange(n * 2.0).reshape(1, n, 2) + 100 * r
             ).requires_grad_()
        y = getattr(dist, name)(x)
        w = torch.arange(float(y.numel())).reshape(y.shape) * (r + 1)
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def sp_scenario(t: dict, mesh, rank: int) -> dict:
    """Sequence parallelism on ``mesh`` from the logical state
    ``t["state"]``: the pairs (``_pairs``); ``t["steps"]`` sharded steps
    with ``sp`` on (the default) and off, each step's logical params and
    masks and its collectives by kind, and the residual stream's shape
    inside the blocks; two steps on ``t["odd"]``'s batches, whose S the
    model axis does not divide; one step with the norms' gradient sum
    left out (``seq_partial_flags`` all False: a planted fault); the
    full-sequence packed prefill ``make_prefill_step`` on ``t["packed"]``
    under ``sp``; the launcher (``train.main --mesh single``) on this
    mesh."""
    import torch.distributed as tdist

    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.launch import mesh as lmesh, train as ltrain
    from repro_torch.serving import step as sstep
    from repro_torch.training import step as ts, train_loop
    cfg, opt = t["cfg"], t["opt"]
    counts = count_collectives()
    shapes = _stream_shapes()
    shd = sharding.state_shardings(cfg, mesh)
    state0 = sharding.shard_state(interop.train_state(t["state"],
                                                      device="cpu"), shd)
    dist = DistContext(mesh)
    out = {"pairs": _pairs(dist), "rank": dist.model_rank,
           "data_rank": dist.data_rank, "default_sp": dist.sp}

    def run(d, src, n):
        step = ts.make_train_step(cfg, opt, dist=d)
        st, runs = state0, []
        for i in range(n):
            b = sharding.slice_batch({k: torch.as_tensor(v) for k, v in
                                      src.batch(i).items()}, d)
            counts.clear()
            shapes.clear()
            st, m = step(st, b)
            runs.append(dict(metrics=_host(m), collectives=dict(counts),
                             stream=sorted(set(shapes)),
                             **_gathered(st, shd)))
        return runs

    out["sp"] = run(dist, t["source"], t["steps"])
    out["sp_off"] = run(DistContext(mesh, sp=False), t["source"], t["steps"])
    out["odd"] = run(dist, t["odd"], 2)
    flags = sharding.seq_partial_flags
    sharding.seq_partial_flags = lambda c: ts.adamw.tree_map(
        lambda _: False, flags(c))
    try:
        out["planted"] = run(dist, t["source"], 1)
    finally:
        sharding.seq_partial_flags = flags

    pcfg = t["packed_cfg"]
    params = interop.to_torch_shard(t["packed"], pcfg, mesh, device="cpu")
    counts.clear()
    shapes.clear()
    with torch.inference_mode():
        logits = sstep.make_prefill_step(pcfg, dist)(
            params, torch.as_tensor(t["prompts"]))
    out["prefill"] = dict(logits=logits.numpy(), collectives=dict(counts),
                          stream=sorted(set(shapes)))

    seen, train = {}, train_loop.train
    made = lmesh.make_production_mesh

    def spy(*a, **kw):
        seen["sp"] = kw["dist"].sp
        return train(*a, **kw)
    lmesh.make_production_mesh = lambda multi_pod=False: make_mesh(
        tuple(mesh.shape), mesh.axis_names)
    train_loop.train = spy
    try:
        counts.clear()
        shapes.clear()
        _, hist = ltrain.main(t["launch"] + ["--mesh", "single"])
    finally:
        lmesh.make_production_mesh, train_loop.train = made, train
    out["launch"] = dict(sp=seen["sp"], collectives=dict(counts),
                         stream=sorted(set(shapes)),
                         losses=[h["loss"] for h in hist if "loss" in h])
    tdist.barrier()
    return out


def kd_scenario(t: dict, mesh, rank: int) -> dict:
    """Distillation on ``mesh`` from the logical state ``t["state"]``
    with the dense teacher ``t["teacher"]`` (whole, numpy), KD weight
    ``t["beta"]``: ``t["steps"]`` sharded steps with the in-step teacher
    with ``sp`` off and on, with the batches' precomputed whole-vocab
    ``t["teacher_logits"]``, over two microbatches, through
    ``train_loop.train`` (the whole teacher given to it), the deferred
    step uncompressed and int8-compressed (as ``train_scenario``'s), the
    KL with its logsumexp made local (a planted fault), and the loss and
    gradient of ``distill_loss`` at temperature 2 on ``t["kl"]``'s
    logits, correct and planted."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.core import distill
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import DistContext
    from repro_torch.optim import adamw, compress
    from repro_torch.training import deferred, step as ts, train_loop
    cfg, opt, src, beta = t["cfg"], t["opt"], t["source"], t["beta"]
    counts = count_collectives()
    shd = sharding.state_shardings(cfg, mesh)
    state0 = sharding.shard_state(interop.train_state(t["state"],
                                                      device="cpu"), shd)
    whole = interop.to_torch(t["teacher"], device="cpu")
    teacher = sharding.shard_teacher(cfg, whole, mesh)
    dist, off = DistContext(mesh), DistContext(mesh, sp=False)
    kd = dict(kd_beta=beta, teacher_cfg=cfg)
    out = {"data_rank": dist.data_rank, "model_rank": dist.model_rank}

    def batch(i, d, microbatches=1, logits=False):
        b = {k: torch.as_tensor(v) for k, v in src.batch(i).items()}
        if logits:
            b["teacher_logits"] = torch.as_tensor(t["teacher_logits"][i])
        return sharding.slice_batch(b, d, microbatches)

    def run(d, step, n=t["steps"], **bkw):
        st, runs = state0, []
        for i in range(n):
            counts.clear()
            st, m = step(st, batch(i, d, **bkw))
            runs.append(dict(metrics=_host(m), collectives=dict(counts),
                             **_gathered(st, shd)))
        return runs

    out["off"] = run(off, ts.make_train_step(
        cfg, opt, dist=off, teacher_params_static=teacher, **kd))
    out["sp"] = run(dist, ts.make_train_step(
        cfg, opt, dist=dist, teacher_params_static=teacher, **kd))
    out["pre"] = run(dist, ts.make_train_step(cfg, opt, dist=dist, **kd),
                     logits=True)
    out["mb"] = run(dist, ts.make_train_step(
        cfg, opt, dist=dist, teacher_params_static=teacher, microbatches=2,
        **kd), microbatches=2)
    _, hist = train_loop.train(
        cfg, opt, src, train_loop.TrainLoopConfig(total_steps=t["steps"],
                                                  log_every=1),
        state=state0, device="cpu", dist=dist, teacher_params=whole,
        teacher_cfg=cfg, kd_beta=beta, log_fn=lambda e: None)
    out["loop"] = [h["loss"] for h in hist if "loss" in h]

    st = dataclasses.replace(state0, opt_state=deferred.init_opt_state(
        cfg, state0.params, False))
    dstep = deferred.make_train_step_deferred(
        cfg, opt, dist, microbatches=2, compress_grads=False,
        teacher_params_static=teacher, **kd)
    out["deferred"] = []
    for i in range(t["steps"]):
        st, m = dstep(st, batch(i, dist))
        out["deferred"].append(dict(metrics=_host(m), **_gathered(st, shd)))
    cstep = deferred.make_train_step_deferred(
        cfg, opt, dist, microbatches=2, compress_grads=True,
        teacher_params_static=teacher, **kd)
    sc = dataclasses.replace(state0, opt_state=deferred.init_opt_state(
        cfg, state0.params, True))
    out["compress_err"], out["deferred_c"] = [], []
    for i in range(2):
        b = batch(i, dist)
        tl = ts.teacher_logits_of(cfg, b, cfg, teacher, dist)
        _, _, g = ts.loss_and_grads(cfg, sc, b, dist, 2, tl, 1.0, beta,
                                    over_data=False)
        ef = sc.opt_state["ef"]
        comp, _ = compress.compressed_psum(g, ef, dist)
        ge = adamw.tree_map(torch.add, g, ef)
        f32 = adamw.tree_map(lambda x: dist.mean_over_data(x.clone()), ge)
        scale = adamw.tree_map(
            lambda x: dist.max_over_data(x.abs().max() / 127.0), ge)
        out["compress_err"] += [
            (float((a - b).abs().max()), float(s) / 2)
            for a, b, s in zip(*(adamw.tree_leaves(x)
                                 for x in (comp, f32, scale)))]
        before = dict(step=sc.step, **_gathered(sc, shd, moments=True))
        counts.clear()
        sc, m = cstep(sc, b)
        out["deferred_c"].append(dict(
            metrics=_host(m), before=before, collectives=dict(counts),
            comp=_np(sharding.gather_tree(comp, shd.params)),
            **_gathered(sc, shd, moments=True)))

    def local_lse(x, d):
        return torch.log_softmax(x, -1), torch.logsumexp(x, -1)

    def kl_unit():
        s_all, t_all, labels = (torch.as_tensor(x) for x in t["kl"])
        rows = s_all.shape[0] // dist.data_size
        v = s_all.shape[-1] // dist.tp
        cut = lambda x: x.narrow(0, dist.data_rank * rows, rows)  # noqa
        s_loc = cut(s_all).narrow(-1, dist.model_rank * v, v).clone()
        s_loc.requires_grad_()
        loss = distill.distill_loss(
            s_loc, cut(labels), cut(t_all).narrow(-1, dist.model_rank * v,
                                                  v),
            alpha=1.0, beta=beta, temperature=2.0, dist=dist,
            vocab_parallel=True)
        loss.backward()
        return float(loss), s_loc.grad.numpy()

    out["kl"] = kl_unit()
    vp = distill._vp_log_softmax
    distill._vp_log_softmax = local_lse
    try:
        out["kl_planted"] = kl_unit()
        out["planted"] = run(dist, ts.make_train_step(
            cfg, opt, dist=dist, teacher_params_static=teacher, **kd), n=1)
    finally:
        distill._vp_log_softmax = vp
    return out


def _ep_forward(m, dist, mesh, seqs=(False, True)) -> dict:
    """``moe_forward(axis_name=dist)`` on layer 0 of the rank's shard of
    the dense params and of the packed tree, on ``m["x"]`` (whole, or
    with ``seq`` this rank's S shard): {(kind, seq): (y, aux)}, and the
    MoE layer's calls by (tokens, C) on this rank."""
    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.models import moe, transformer
    cfg = m["cfg"]
    dense = sharding.shard_tree(
        interop.to_torch(m["state"].params, device="cpu"),
        sharding.state_shardings(cfg, mesh).params)
    packed = interop.to_torch_shard(m["params"], cfg, mesh, device="cpu")
    x = torch.as_tensor(m["x"])
    out = {}
    moe.CALLS.clear()
    with torch.inference_mode():
        for kind, tree in (("dense", dense), ("packed", packed)):
            p0 = transformer._layer_view(tree["layers"], 0)["mlp"]
            for seq in seqs:
                xi = dist.seq_slice(x) if seq else x
                y, aux = moe.moe_forward(cfg, p0, xi, axis_name=dist,
                                         seq=seq)
                out[(kind, seq)] = (y.numpy(), float(aux))
    return {"out": out, "calls": dict(moe.CALLS),
            "experts": [int(dense["layers"]["mlp"]["w_gate"].shape[1]),
                        int(packed["layers"]["mlp"]["w_gate"].idx.shape[1])]}


def _ep_train(cfg, t, state, dist, grads=False) -> dict:
    """One sharded step of ``cfg`` from the logical ``state`` (numpy) on
    this rank's rows of global batch 0: the metrics and the logical
    params and masks after it; with ``grads`` also the logical dense
    gradients of that batch (``loss_and_grads``)."""
    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.training import step as ts
    shd = sharding.state_shardings(cfg, dist.mesh)
    st = sharding.shard_state(interop.train_state(state, device="cpu"), shd)
    b = sharding.slice_batch({k: torch.as_tensor(v) for k, v in
                              t["source"].batch(0).items()}, dist)
    out = {}
    if grads:
        _, aux, g = ts.loss_and_grads(cfg, st, b, dist)
        out["grads"] = _np(sharding.gather_tree(g, shd.params))
        out["aux"] = float(aux)
    st, metrics = ts.make_train_step(cfg, t["opt"], dist=dist)(st, b)
    out.update(metrics=_host(metrics), **_gathered(st, shd))
    return out


def ep_scenario(t: dict, mesh, rank: int) -> dict:
    """Expert parallelism on 4 ranks. Ranks 0-1 and 2-3 are two meshes
    of (data 1, model 2), one per MoE config of ``t["archs"]``: each
    holds its experts' slice, runs ``moe_forward`` on layer 0
    (``_ep_forward``: dense and packed, the stream whole and S-split),
    serves the packed tree (``serve_model``: ``serve_loop.generate``
    and the paged engine, phased, mixed and prefix-cached), takes one
    train step with ``sp`` on and off (with the gradients, sp on), and
    repeats the forward with every rank's expert offset left at 0 and
    the step with the aux gradient counted on every rank (two planted
    faults). Then all four ranks, ``mesh`` (data 2, model 2), take one
    step of each config, ``sp`` on and off."""
    import torch.distributed as tdist

    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.models import moe
    pairs = [make_mesh((1, 2), ("data", "model"), ranks=[0, 1]),
             make_mesh((1, 2), ("data", "model"), ranks=[2, 3])]
    pair = 0 if pairs[0] is not None else 1
    m2 = pairs[pair]
    arch = t["archs"][pair]
    m = t["models"][arch]
    cfg = m["cfg"]
    dist = DistContext(m2)
    out = {"arch": arch, "model_rank": dist.model_rank,
           "forward": _ep_forward(m, dist, m2)}
    moe.CALLS.clear()
    out["serve"] = serve_model(m["serve"], dist, m2, "cpu")
    out["serve"]["calls"] = dict(moe.CALLS)
    out["m2"] = {sp: _ep_train(cfg, t, m["state"], DistContext(m2, sp=sp),
                               grads=sp) for sp in (True, False)}

    er, once = DistContext.expert_range, DistContext.count_once
    DistContext.expert_range = lambda self, e: (0, e // self.tp)
    try:
        out["planted_offset"] = _ep_forward(m, dist, m2, seqs=(False,))
    finally:
        DistContext.expert_range = er
    DistContext.count_once = lambda self, x: x
    try:
        out["planted_aux"] = _ep_train(cfg, t, m["state"], dist, grads=True)
    finally:
        DistContext.count_once = once
    tdist.barrier()
    out["d2m2"] = {a: {sp: _ep_train(t["models"][a]["cfg"], t,
                                     t["models"][a]["state"],
                                     DistContext(mesh, sp=sp))
                       for sp in (True, False)} for a in t["archs"]}
    return out


def _tp_logits(cfg, params, m, dist, masks=None) -> dict:
    """The training forward of ``m["fwd"]`` (tokens and whisper's frames
    or a VLM's patches) on this rank's shard: the whole logits (the
    vocab shards gathered) with ``sp`` off and on."""
    from repro_torch.models import registry
    toks, extra = m["fwd"]
    out = {}
    with torch.no_grad():
        for sp in (False, True):
            d = dataclasses.replace(dist, sp=sp)
            lg, _ = registry.forward(
                cfg, params, torch.as_tensor(toks), masks=masks, dist=d,
                **{k: torch.as_tensor(v) for k, v in extra.items()})
            if d.shards(cfg.vocab_size):
                lg = d.all_gather(lg, dim=-1)
            out[sp] = lg.numpy()
    return out


def _tp_train(cfg, m, opt, dist, counts, grads=False, key="batch") -> dict:
    """One sharded step of ``cfg`` from the logical ``m["state"]`` on
    this rank's rows of ``m[key]`` (with its frames or patches): the
    metrics, the logical params and masks after it, the collectives by
    kind; with ``grads`` the logical dense gradients too."""
    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.training import step as ts
    shd = sharding.state_shardings(cfg, dist.mesh)
    st = sharding.shard_state(interop.train_state(m["state"], device="cpu"),
                              shd)
    b = sharding.slice_batch({k: torch.as_tensor(v)
                              for k, v in m[key].items()}, dist)
    out = {"local_bytes": sharding.count_bytes(st.params)}
    if grads:
        _, _, g = ts.loss_and_grads(cfg, st, b, dist)
        out["grads"] = _np(sharding.gather_tree(g, shd.params))
    counts.clear()
    st, metrics = ts.make_train_step(cfg, opt, dist=dist)(st, b)
    out.update(metrics=_host(metrics), collectives=dict(counts),
               **_gathered(st, shd))
    return out


def _tp_serve_audio(m, dist, mesh) -> dict:
    """Whisper on this rank's shard of the packed tree: ``prefill_cross``
    (the rank's cross K/V) and ``serve_loop.generate(frames=)``
    streams."""
    from repro_torch import interop
    from repro_torch.models import whisper
    from repro_torch.serving import export, serve_loop
    cfg, sv = m["cfg"], m["serve"]
    params = interop.to_torch_shard(sv["params"], cfg, mesh, device="cpu")
    frames = torch.as_tensor(sv["frames"])
    with torch.inference_mode():
        ck, cv = whisper.prefill_cross(cfg, params, frames,
                                       dtype=torch.float32, dist=dist)
        toks = serve_loop.generate(cfg, params, sv["equal"],
                                   max_new_tokens=sv["new"], frames=frames,
                                   device="cpu", dist=dist)[0]
    return {"loop": toks, "ck": ck.numpy(), "cv": cv.numpy(),
            "weight_bytes": export.memory_report(cfg, params)["bytes"]}


def tp_scenario(t: dict, mesh, rank: int) -> dict:
    """Tensor parallelism on 4 ranks for the two-matrix MLP and the vlm
    and audio families. Ranks 0-1 and 2-3 are two (data 1, model 2)
    meshes, one per model of ``t["pairs"]``: each runs the training
    forward of its dense shard (``_tp_logits``, ``sp`` off and on),
    serves its packed shard (whisper: ``_tp_serve_audio``; otherwise
    ``serve_model``: ``serve_loop.generate`` and the paged engine), and
    takes one train step with ``sp`` on (with the gradients) and off.
    Then all four ranks, ``mesh`` (data 2, model 2), take one step of
    each model on its ``batch2`` (else its ``batch``), ``sp`` on and
    off, and with ``t["loop"]`` (a model name)
    run ``train_loop.train`` on that model's token source."""
    import torch.distributed as tdist

    from repro_torch import interop
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.training import train_loop
    counts = count_collectives()
    pairs = [make_mesh((1, 2), ("data", "model"), ranks=[0, 1]),
             make_mesh((1, 2), ("data", "model"), ranks=[2, 3])]
    pair = 0 if pairs[0] is not None else 1
    m2 = pairs[pair]
    name = t["pairs"][pair]
    m = t["models"][name]
    cfg = m["cfg"]
    dist = DistContext(m2)
    dense = sharding.shard_tree(
        interop.to_torch(m["state"].params, device="cpu"),
        sharding.state_shardings(cfg, m2).params)
    out = {"name": name, "model_rank": dist.model_rank,
           "logits": _tp_logits(cfg, dense, m, dist)}
    if cfg.family == "audio":
        out["serve"] = _tp_serve_audio(m, dist, m2)
    else:
        out["serve"] = serve_model(m["serve"], dist, m2, "cpu")
    out["m2"] = {sp: _tp_train(cfg, m, t["opt"], DistContext(m2, sp=sp),
                               counts, grads=sp) for sp in (True, False)}
    tdist.barrier()
    models = t["models"]
    out["d2m2"] = {n: {sp: _tp_train(
        models[n]["cfg"], models[n], t["opt"], DistContext(mesh, sp=sp),
        counts, key="batch2" if "batch2" in models[n] else "batch")
        for sp in (True, False)} for n in t["pairs"]}
    if t.get("loop"):
        lm = t["models"][t["loop"]]
        _, hist = train_loop.train(
            lm["cfg"], t["opt"], t["source"],
            train_loop.TrainLoopConfig(total_steps=2, log_every=1),
            state=sharding.shard_state(
                interop.train_state(lm["state"], device="cpu"),
                sharding.state_shardings(lm["cfg"], mesh)),
            device="cpu", dist=DistContext(mesh), log_fn=lambda e: None)
        out["loop"] = [h["loss"] for h in hist if "loss" in h]
    return out


def _ssm_serve(m, dist, device="cpu") -> dict:
    """A recurrent model's packed shard (``m["params"]`` whole, cut
    here) through ``serve_loop.generate`` (greedy and sampled) and
    ``prefill_with_decode`` into an f32 cache (the prompts' last
    logits, the vocab shards gathered), the launch counters reset just
    before and read just after."""
    from repro_torch import interop
    from repro_torch.kernels import bspmm
    from repro_torch.serving import export, serve_loop
    cfg = m["cfg"]
    params = interop.to_torch_shard(m["params"], cfg, dist.mesh,
                                    device=device)
    bspmm.LAUNCHES.update(dict.fromkeys(bspmm.LAUNCHES, 0))
    out = {"weight_bytes": export.memory_report(cfg, params)["bytes"]}
    with torch.inference_mode():
        out["loop"] = serve_loop.generate(
            cfg, params, m["equal"], max_new_tokens=m["new"],
            device=device, dist=dist)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        out["sampled"] = serve_loop.generate(
            cfg, params, m["equal"], max_new_tokens=m["new"],
            temperature=0.8, generator=gen, device=device, dist=dist)[0]
        from repro_torch.models import registry
        init = registry.init_cache

        def f32(*a, **kw):
            return init(*a, **dict(kw, dtype=torch.float32))
        registry.init_cache = f32
        try:
            last, _ = serve_loop.prefill_with_decode(
                cfg, params, m["equal"], m["equal"].shape[1],
                device=device, dist=dist)
        finally:
            registry.init_cache = init
        if dist.shards(cfg.vocab_size):
            last = dist.all_gather(last, dim=-1)
        out["prefill_logits"] = last.numpy()
    out["launches"] = dict(bspmm.LAUNCHES)
    return out


def ssm_scenario(t: dict, mesh, rank: int) -> dict:
    """``dist=`` on the recurrent families on 4 ranks. Ranks 0-1 (rwkv6)
    and 2-3 (zamba) are two (data 1, model 2) meshes: each runs the
    training forward of its dense shard (``sp`` off and on), one train
    step with ``sp`` on (with the gradients) and off, and serves its
    packed shard (``_ssm_serve``). Then all four, ``mesh`` (data 2, model
    2), take one step of each model, ``sp`` on and off, serve each
    (rows split over the data axis), and restore a zamba train state
    saved from the (data 2, model 2) layout onto (data 1, model 4), onto
    (data 2, model 2) and onto one device (``Checkpointer.restore_state
    (shardings=)``)."""
    import torch.distributed as tdist

    from repro_torch import interop
    from repro_torch.checkpointing.checkpoint import Checkpointer
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import DistContext, make_mesh
    counts = count_collectives()
    pairs = [make_mesh((1, 2), ("data", "model"), ranks=[0, 1]),
             make_mesh((1, 2), ("data", "model"), ranks=[2, 3])]
    pair = 0 if pairs[0] is not None else 1
    m2 = pairs[pair]
    name = t["pairs"][pair]
    m = t["models"][name]
    cfg = m["cfg"]
    dist = DistContext(m2)
    dense = sharding.shard_tree(
        interop.to_torch(m["state"].params, device="cpu"),
        sharding.state_shardings(cfg, m2).params)
    out = {"name": name, "model_rank": dist.model_rank,
           "logits": _tp_logits(cfg, dense, m, dist),
           "serve": _ssm_serve(m["serve"], dist)}
    out["m2"] = {sp: _tp_train(cfg, m, t["opt"], DistContext(m2, sp=sp),
                               counts, grads=sp) for sp in (True, False)}
    tdist.barrier()
    models = t["models"]
    out["d2m2"] = {n: {sp: _tp_train(models[n]["cfg"], models[n], t["opt"],
                                     DistContext(mesh, sp=sp), counts)
                       for sp in (True, False)} for n in t["pairs"]}
    out["serve22"] = {n: _ssm_serve(models[n]["serve"], DistContext(mesh))
                      for n in t["pairs"]}
    # elastic: a zamba state saved from (data 2, model 2), restored onto
    # other meshes
    z = models["zamba"]
    zcfg = z["cfg"]
    st = interop.train_state(z["state"], device="cpu")
    sh22 = sharding.state_shardings(zcfg, mesh)
    local = sharding.shard_state(st, sh22)
    whole = sharding.gather_state(local, sh22)
    # one writer: a writer drops stale ``.tmp`` dirs when it is made, so
    # a second one could remove rank 0's write in flight
    ck = Checkpointer(t["ckpt_dir"], writer=rank == 0)
    if rank == 0:
        ck.save(3, whole)
        ck.wait()
    tdist.barrier()
    m4 = make_mesh((1, 4), ("data", "model"))
    restored = {}
    for key, msh in (("m4", m4), ("d2m2", mesh)):
        sh = sharding.state_shardings(zcfg, msh)
        got = ck.restore_state(st, shardings=sh)
        want = sharding.shard_state(st, sh)
        restored[key] = [bool(torch.equal(a, b)) for a, b in zip(
            _leaves_of(got), _leaves_of(want))]
    one = ck.restore_state(st)
    restored["one"] = [bool(torch.equal(a, b)) for a, b in zip(
        _leaves_of(one), _leaves_of(st))]
    restored["cut"] = {k: sharding.model_sharded(v.spec) for k, v in
                       sharding.state_shardings(zcfg, m4).params[
                           "layers"].items()}
    out["elastic"] = restored
    return out


def _leaves_of(state):
    from repro_torch.optim.adamw import tree_leaves
    return (tree_leaves(state.params) + tree_leaves(state.masks)
            + [x for k in ("m", "v") for x in tree_leaves(
                state.opt_state[k])])


def dp_scenario(t: dict, mesh, rank: int) -> dict:
    """The serving data axis on 4 ranks: first ranks 0-1 as (data 2,
    model 1), then all four as (data 2, model 2) (``mesh``). On each, per
    model of ``t["models"]`` that names the mesh in its ``meshes`` (whole
    packed trees, cut here):
    ``serve_loop.generate`` greedy and sampled, B = 3 too (which the data
    axis does not divide), ``make_prefill_step``, and the paged
    ``Engine`` in each mode of ``t["modes"]`` with the lanes of
    ``t["max_batch"]`` (block tables and page accounting after every
    step of this rank's group, its digest, every group's results); an
    engine of 3 lanes must be refused."""
    import torch.distributed as tdist

    from repro_torch import interop
    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.serving import engine, serve_loop, step
    meshes = {"d2m1": make_mesh((2, 1), ("data", "model"), ranks=[0, 1]),
              "d2m2": mesh}
    out = {"rank": rank}
    for key, msh in meshes.items():
        tdist.barrier()
        if msh is None:
            continue
        dist = DistContext(msh)
        runs = {}
        for name, m in t["models"].items():
            if key not in m["meshes"]:
                continue
            cfg = m["cfg"]
            params = interop.to_torch_shard(m["params"], cfg, msh,
                                            device="cpu")
            r = {"data_rank": dist.data_rank, "model_rank": dist.model_rank}
            with torch.inference_mode():
                r["loop"] = serve_loop.generate(
                    cfg, params, m["equal"], max_new_tokens=m["new"],
                    device="cpu", dist=dist)[0]
                r["loop3"] = serve_loop.generate(
                    cfg, params, m["equal"][:3], max_new_tokens=m["new"],
                    device="cpu", dist=dist)[0]
                gen = torch.Generator(device="cpu")
                gen.manual_seed(7)
                r["sampled"] = serve_loop.generate(
                    cfg, params, m["equal"], max_new_tokens=m["new"],
                    temperature=0.8, generator=gen, device="cpu",
                    dist=dist)[0]
                r["prefill"] = step.make_prefill_step(cfg, dist)(
                    params, torch.as_tensor(m["equal"])).numpy()
            for mode in m["modes"]:
                eng = engine.Engine(cfg, params, device="cpu", dist=dist,
                                    max_batch=t["max_batch"], **m["engine"],
                                    **MODES[mode])
                prompts = m["prefix_prompts" if mode == "prefix"
                            else "ragged"]
                uids = [eng.submit(p, m["new"]) for p in prompts]
                snaps, stepped = [], eng.step

                def step_and_snap(eng=eng, stepped=stepped, snaps=snaps):
                    done = stepped()
                    snaps.append(snapshot(eng))
                    return done
                eng.step = step_and_snap
                res = eng.run()
                r[mode] = {"uids": uids, "snaps": snaps,
                           "streams": [res[u].tokens for u in uids],
                           "digests": eng.data_group_digests,
                           "lanes": eng.max_batch,
                           "hits": eng.stats["prefix_hits"]}
            if m.get("invalid"):
                r["invalid"] = _invalid_submits(engine, cfg, params, dist,
                                                t["max_batch"], m)
            try:
                engine.Engine(cfg, params, device="cpu", dist=dist,
                              max_batch=3, **m["engine"])
                r["refused3"] = False
            except NotImplementedError as e:
                r["refused3"] = "ROADMAP §1 item 4" in str(e)
            runs[name] = r
        out[key] = runs
    return out


def _invalid_submits(engine, cfg, params, dist, lanes, m) -> dict:
    """A phased engine fed ``m["ragged"]`` with an infeasible submit
    before each of the first three (an empty prompt, a zero budget, a
    prompt filling ``max_len``): how many raised here, every request's
    stream from ``run``, and whether ``admission_queue_limit`` was
    refused."""
    eng = engine.Engine(cfg, params, device="cpu", dist=dist,
                        max_batch=lanes, **m["engine"])
    bad = [(np.zeros(0, np.int32), m["new"]), (m["ragged"][0], 0),
           (np.ones(m["engine"]["max_len"], np.int32), m["new"])]
    uids, raised = [], 0
    for j, p in enumerate(m["ragged"]):
        if j < len(bad):
            try:
                eng.submit(*bad[j])
            except ValueError:
                raised += 1
        uids.append(eng.submit(p, m["new"]))
    res = eng.run()
    out = {"raised": raised, "results": len(res),
           "streams": [res[u].tokens for u in uids]}
    try:
        engine.Engine(cfg, params, device="cpu", dist=dist,
                      max_batch=lanes, admission_queue_limit=2,
                      **m["engine"])
        out["shed_refused"] = False
    except NotImplementedError as e:
        out["shed_refused"] = "ROADMAP §1 item 4" in str(e)
    return out


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    init_process_group(spec["dir"], rank, spec["world"])
    try:
        scenario = next((k for k in ("train", "sp", "kd", "ep", "tp",
                                     "ssm", "dp") if k in spec), None)
        if scenario is not None:
            t = spec[scenario]
            run = {"train": train_scenario, "sp": sp_scenario,
                   "kd": kd_scenario, "ep": ep_scenario,
                   "tp": tp_scenario, "ssm": ssm_scenario,
                   "dp": dp_scenario}[scenario]
            out = run(t, make_mesh(t["mesh"], ("data", "model")), rank)
        else:
            mesh = make_mesh((1, spec["world"]), ("data", "model"))
            dist = DistContext(mesh)
            out = {name: serve_model(m, dist, mesh, device)
                   for name, m in spec["models"].items()}
    finally:
        import torch.distributed as tdist
        tdist.destroy_process_group()
    with open(os.path.join(spec["dir"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def start(directory: str, world: int, models: dict | None = None,
          device: str = "cpu", train: dict | None = None,
          scenario: str = "train"):
    """Write the spec into ``directory`` (a fresh one: it holds the gloo
    store) and start ``world`` rank processes; returns them. ``train``
    runs the ``scenario`` ('train': ``train_scenario``, 'sp':
    ``sp_scenario``, 'kd': ``kd_scenario``, 'ep': ``ep_scenario``, 'tp':
    ``tp_scenario``, 'ssm': ``ssm_scenario``, 'dp': ``dp_scenario``)
    instead of serving ``models``."""
    path = os.path.join(directory, "spec.pkl")
    spec = {"dir": directory, "world": world, "device": device,
            "models": models or {}}
    if train is not None:
        spec[scenario] = train
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), path, str(r)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(directory: str, procs, timeout: float = 300.0) -> list[dict]:
    """Wait for the ranks (all are killed if one overruns); each rank's
    results, in rank order. A rank that failed raises with its log."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode:
            with open(os.path.join(directory, f"rank{r}.log")) as f:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   + f.read()[-4000:])
    out = []
    for r in range(len(procs)):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
