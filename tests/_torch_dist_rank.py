"""One rank of the tensor-parallel serving scenarios
(``test_torch_dist_serving.py`` on the CPU, ``test_torch_dist_gpu.py`` on
the card). Imports torch and the port only, never JAX:

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
        mesh = make_mesh((1, spec["world"]), ("data", "model"))
        dist = DistContext(mesh)
        out = {name: serve_model(m, dist, mesh, device)
               for name, m in spec["models"].items()}
    finally:
        import torch.distributed as tdist
        tdist.destroy_process_group()
    with open(os.path.join(spec["dir"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def start(directory: str, world: int, models: dict, device: str = "cpu"):
    """Write the spec into ``directory`` (a fresh one: it holds the gloo
    store) and start ``world`` rank processes; returns them."""
    path = os.path.join(directory, "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump({"dir": directory, "world": world, "device": device,
                     "models": models}, f)
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
