"""Tensor-parallel serving on the CPU (``dist=``): gloo ranks against the
reference's single device.

One scenario per model-axis size (tp 2 and tp 4), each a set of rank
processes started once (``_torch_dist_rank.py``, a ``file://`` store
under the test's temporary directory) that serves ``tiny_cfg`` (4 query
over 2 kv heads, d_model 64, d_ff 128: at tp 4 the kv heads do not split
and the down pack, 2 kept blocks a column, is replicated) and
``LLAMA32_1B_SMOKE`` (s = 0.7: 3 kept down blocks a column, padded to 4
at tp 2 and replicated at tp 4) and an edge model whose vocabulary and
gate/up columns split 2 ways but not 4, packed, in f32. Every rank's greedy
streams through ``serve_loop.generate`` and the paged ``Engine``
(phased, mixed, prefix-cached) must equal the reference's single-device
ones, a divergence accepted only where the reference's top-2 margin is
below 1e-5; the engines' block tables and page accounting after every
step must equal the reference engine's bitwise on every rank; the
gathered next-token logits must match the reference's within 1e-5
relative (the all-reduces reorder the sums). The ranks also draw the
same sampled tokens as each other and as the port on one device. The
options this slice refuses under ``dist`` are checked in-process on a
mesh that starts no process group (nothing there reaches a collective).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core.packing import PackedBCSC as JPacked  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import serve_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.packing import PackedBCSC  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.serving import serve_loop as tloop  # noqa: E402
from test_torch_engine import _assert_same_or_near_tie  # noqa: E402
from test_torch_engine import _ref_margin  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

# few page and chunk buckets: each is a compile of the reference engine
ENGINE = dict(max_batch=2, max_len=32, prefill_chunk=8, page_size=8,
              slab_k=4)
NEW, RTOL = 6, 1e-5
TPS = (2, 4)
MODES = tuple(ranks.MODES)


# name -> engine modes run (the prefix cache once: each reference engine
# run compiles for seconds)
RUNS = {"tiny": MODES, "smoke": ("phased", "mixed"), "edge": ("phased",)}
NAMES = tuple(RUNS)


def _models():
    """name -> (reference config, sparsity). ``edge``: 62 tokens (the
    vocabulary splits 2 ways, not 4) and 6 column-blocks of gate/up (the
    same), so at tp 4 the embedding, the logits and the whole MLP stay
    replicated while the heads split."""
    return {"tiny": (tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64,
                              d_ff=128), 0.8),
            "smoke": (jpm.LLAMA32_1B_SMOKE, 0.7),
            "edge": (tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64,
                              d_ff=96, vocab_size=62), 0.8)}


def _packed(cfg, s):
    """The launcher's one-shot magnitude prune at ``s``, packed in f32 by
    the port (seeded there: the reference's init and prune would compile
    for seconds, and both sides are handed the same weights anyway)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    from repro_torch.models import registry
    from repro_torch.serving import export
    params = registry.init_params(cfg, 0, device="cpu")
    spec = dataclasses.replace(cfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        masks[path] = initial_mask(pspec, sm.get_path(params, path))
    return export.pack_params(cfg, params, masks, dtype=torch.float32)


def _numpy_tree(tree):
    """The port's tree as numpy, packs as plain namespaces (what a rank
    process unpickles)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return types.SimpleNamespace(
            blocks=tree.blocks.numpy(), idx=tree.idx.numpy(), kb=tree.kb,
            joint=tree.joint)
    return tree.numpy()


def _reference_tree(tree):
    """The same weights as the reference's tree."""
    if isinstance(tree, dict):
        return {k: _reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, types.SimpleNamespace):
        return JPacked(blocks=jnp.asarray(tree.blocks),
                       idx=jnp.asarray(tree.idx), kb=tree.kb,
                       joint=tree.joint)
    return jnp.asarray(tree)


def _traffic(vocab, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 10).astype(np.int32)
    return dict(
        equal=rng.integers(1, vocab, (3, 8)).astype(np.int32),
        ragged=[rng.integers(1, vocab, int(n)).astype(np.int32)
                for n in (5, 9, 13, 3, 7)],
        prefix_prompts=[np.concatenate(
            [prefix, rng.integers(1, vocab, int(n)).astype(np.int32)])
            for n in (3, 5, 2, 6)],
        logit_prompts=[rng.integers(1, vocab, int(n)).astype(np.int32)
                       for n in (6, 11)])


def _ref_engine(jcfg, jp, prompts, kw):
    eng = jengine.Engine(jcfg, jp, **ENGINE, **kw)
    uids = [eng.submit(p, NEW) for p in prompts]
    out, snaps = {}, []
    while len(eng.scheduler) or eng.active_lanes:
        out.update((r.uid, r) for r in eng.step())
        snaps.append(ranks.snapshot(eng))
    return [np.asarray(out[u].tokens) for u in uids], snaps


def _ref_logits(jcfg, jp, prompt, ps=4):
    pages = -(-len(prompt) // ps)
    logits, _ = jtr.paged_prefill_chunk(
        jcfg, jp, jtr.init_paged_cache(jcfg, pages, ps, dtype=jnp.float32),
        jnp.asarray(prompt)[None], 0, jnp.zeros((1,), jnp.int32),
        jnp.arange(pages, dtype=jnp.int32)[None], read_pages=pages)
    return np.asarray(logits[0, -1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both scenarios' ranks, compute the reference meanwhile,
    collect. -> {"ref": per model, tp: per-rank results}."""
    models, specs = {}, {}
    for name, (jcfg, s) in _models().items():
        tree = _numpy_tree(_packed(port_cfg(jcfg), s))
        models[name] = (jcfg, _reference_tree(tree))
        specs[name] = dict(cfg=port_cfg(jcfg), params=tree, engine=ENGINE,
                           new=NEW, modes=RUNS[name],
                           **_traffic(jcfg.vocab_size))
    started = {}
    for tp in TPS:
        d = str(tmp_path_factory.mktemp(f"tp{tp}"))
        started[tp] = (d, ranks.start(d, tp, specs))
    ref = {}
    for name, (jcfg, jp) in models.items():
        sp = specs[name]
        tp_full = interop.to_torch(sp["params"], device="cpu")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(7)
        ref[name] = dict(
            jcfg=jcfg, jp=jp, spec=sp,
            loop=jloop.generate(jcfg, jp, sp["equal"],
                                max_new_tokens=NEW)[0],
            sampled=tloop.generate(sp["cfg"], tp_full, sp["equal"],
                                   max_new_tokens=NEW, temperature=0.8,
                                   generator=gen, device="cpu")[0],
            logits=[_ref_logits(jcfg, jp, p) for p in sp["logit_prompts"]],
            **{mode: _ref_engine(jcfg, jp, sp["prefix_prompts"]
                                 if mode == "prefix" else sp["ragged"],
                                 ranks.MODES[mode])
               for mode in RUNS[name]})
    out = {"ref": ref}
    for tp, (d, procs) in started.items():
        out[tp] = ranks.collect(d, procs)
    return out


def _margin_at(ref):
    return lambda seq: _ref_margin(ref["jcfg"], ref["jp"], seq)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", NAMES)
def test_serve_loop_streams_match_reference(runs, name, tp):
    ref = runs["ref"][name]
    plen = ref["spec"]["equal"].shape[1]
    for rank in runs[tp]:
        for got, want in zip(rank[name]["loop"], ref["loop"]):
            _assert_same_or_near_tie(got, np.asarray(want), plen,
                                     _margin_at(ref))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name,mode", [(n, m) for n in NAMES
                                       for m in RUNS[n]])
def test_engine_streams_and_pages_match_reference(runs, name, tp, mode):
    ref = runs["ref"][name]
    want_streams, want_snaps = ref[mode]
    prompts = ref["spec"]["prefix_prompts" if mode == "prefix"
                          else "ragged"]
    for rank in runs[tp]:
        got = rank[name][mode]
        for p, g, w in zip(prompts, got["streams"], want_streams):
            _assert_same_or_near_tie(g, w, p.size, _margin_at(ref))
        assert len(got["snaps"]) == len(want_snaps)
        for n, (g, w) in enumerate(zip(got["snaps"], want_snaps)):
            assert g == w, f"step {n}"
    if mode == "prefix":
        assert runs[tp][0][name][mode]["stats"]["prefix_hits"] > 0
    if mode == "mixed":
        assert runs[tp][0][name][mode]["stats"]["mixed_steps"] > 0
        assert runs[tp][0][name][mode]["stats"]["stalled_decode_steps"] == 0


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_reference(runs, name, tp):
    ref = runs["ref"][name]
    for rank in runs[tp]:
        for got, want in zip(rank[name]["logits"], ref["logits"]):
            assert got.shape == want.shape
            np.testing.assert_allclose(
                got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree(runs, name, tp):
    """Equal digests, streams and sampled draws on every rank; the draws
    equal the port's on one device (same generator seed)."""
    first = runs[tp][0][name]
    np.testing.assert_array_equal(first["sampled"],
                                  runs["ref"][name]["sampled"])
    for rank in runs[tp][1:]:
        np.testing.assert_array_equal(rank[name]["sampled"],
                                      first["sampled"])
        np.testing.assert_array_equal(rank[name]["loop"], first["loop"])
        for mode in RUNS[name]:
            assert rank[name][mode]["digest"] == first[mode]["digest"]


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", NAMES)
def test_rank_bytes_shrink(runs, name, tp):
    """Each rank holds less than the whole packed model, and its pool
    holds only the kv heads its query heads read."""
    from repro_torch.serving import export
    cfg = runs["ref"][name]["spec"]["cfg"]
    full = export.memory_report(cfg, interop.to_torch(
        runs["ref"][name]["spec"]["params"], device="cpu"))["bytes"]
    kv = cfg.num_kv_heads
    local_kv = kv // tp if kv % tp == 0 else 1
    n_pages = ENGINE["max_batch"] * -(-ENGINE["max_len"] //
                                      ENGINE["page_size"])
    pool = (2 * cfg.num_layers * n_pages * ENGINE["page_size"] * local_kv
            * cfg.head_dim * 2)                   # K and V, bf16
    for rank in runs[tp]:
        assert rank[name]["weight_bytes"] < full
        assert rank[name]["phased"]["kv_bytes"] == pool


# ---------------------------------------------------------------- refusals
def _dist(shape=(1, 2)):
    return DistContext(Mesh(("data", "model"), shape, rank=0))


def _tiny_port(**kw):
    return port_cfg(tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64,
                             d_ff=128, **kw))


def _full_params(cfg):
    from repro_torch.models import registry
    return registry.init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("option", [
    "contiguous", "preempt", "deadlines", "faults", "sla", "data_axis"])
def test_engine_refuses_options_outside_the_slice(option):
    from repro_torch.serving import engine, faults, scheduler
    cfg = _tiny_port()
    kw = {"contiguous": dict(paged=False), "preempt": dict(preempt=True),
          "deadlines": dict(enforce_deadlines=True),
          "faults": dict(faults=faults.FaultPlan(seed=0)),
          "sla": dict(scheduler=scheduler.SLAScheduler(2, 48)),
          "data_axis": {}}[option]
    dist = _dist((2, 2) if option == "data_axis" else (1, 2))
    lanes = 2
    if option == "data_axis":
        # a data axis serves one replica a data group: 2 lanes split 1 a
        # group; 3 do not split over 2 groups and stay refused
        eng = engine.Engine(cfg, _full_params(cfg), max_batch=2,
                            max_len=48, device="cpu", dist=dist)
        assert eng.max_batch == 1 and eng.dist.data_size == 1
        lanes = 3
    with pytest.raises(NotImplementedError):
        engine.Engine(cfg, _full_params(cfg), max_batch=lanes, max_len=48,
                      device="cpu", dist=dist, **kw)


@pytest.mark.parametrize("what", ["swap", "install_faults", "front_door",
                                  "recovery"])
def test_engine_refuses_serving_behind_traffic(what, tmp_path):
    from repro_torch.serving import engine, faults, frontend, recovery
    cfg = _tiny_port()
    eng = engine.Engine(cfg, _full_params(cfg), max_batch=2, max_len=48,
                        device="cpu", dist=_dist())
    with pytest.raises(NotImplementedError):
        if what == "swap":
            eng.swap_weights(str(tmp_path))
        elif what == "install_faults":
            eng.install_faults(faults.FaultPlan(seed=0))
        elif what == "front_door":
            frontend.AsyncEngine(eng)
        else:
            recovery.Supervisor(eng)


@pytest.mark.parametrize("family", ["mlp2", "moe", "ssm"])
def test_other_families_refuse_dist(family):
    """What stays refused under ``dist``, naming the roadmap: MoE experts
    that do not split evenly (6 over 4), an engine whose lanes do not
    split over the data groups (the two-matrix MLP at (data 2, model 2)
    with 1 lane, which the data axis otherwise admits), and rwkv6's heads
    where they do not split (3 over 2; its 48 padded heads are
    admitted, as is the mesh's data axis)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.context import check_serving
    from repro_torch.serving import engine
    prompts = np.ones((1, 4), np.int32)
    cfg = {"mlp2": port_cfg(jpm.GPT2_SMALL_SMOKE),
           "moe": reduced(get_config("deepseek-moe-16b"), num_experts=6),
           "ssm": reduced(get_config("rwkv6-3b"))}[family]
    shape = {"mlp2": (2, 2), "moe": (1, 4)}.get(family, (2, 2))
    params = _full_params(cfg)
    if family == "moe":
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
            tloop.generate(cfg, params, prompts, max_new_tokens=2,
                           device="cpu", dist=_dist(shape))
    else:
        check_serving(cfg, _dist(shape))
    if family == "ssm":
        uneven = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3,
                                     pad_heads_to=0)
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
            tloop.generate(uneven, params, prompts, max_new_tokens=2,
                           device="cpu", dist=_dist(shape))
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
            engine.Engine(cfg, params, max_batch=1, max_len=16,
                          device="cpu", dist=_dist(shape))
