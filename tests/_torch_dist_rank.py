"""One rank of the tensor-parallel serving scenarios
(``test_torch_dist_serving.py`` on the CPU, ``test_torch_dist_gpu.py`` on
the card) and of the sharded training ones (``test_torch_dist_train.py``,
``train_scenario`` below: a spec with a ``train`` entry). Imports torch
and the port only, never JAX:

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
import os
import pickle
import subprocess
import sys

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
    prefill chunk into an f32 pool, the vocab shards gathered)."""
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
    if dist.shards(cfg.vocab_size):
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
        if "train" in spec:
            t = spec["train"]
            out = train_scenario(t, make_mesh(t["mesh"], ("data", "model")),
                                 rank)
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
          device: str = "cpu", train: dict | None = None):
    """Write the spec into ``directory`` (a fresh one: it holds the gloo
    store) and start ``world`` rank processes; returns them. ``train``
    runs ``train_scenario`` instead of serving ``models``."""
    path = os.path.join(directory, "spec.pkl")
    spec = {"dir": directory, "world": world, "device": device,
            "models": models or {}}
    if train is not None:
        spec["train"] = train
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
