"""The port's weight hot-swap (``repro_torch/serving/hotswap.py`` and the
engine's weight generations) through the cases of the reference's
``tests/test_hotswap.py`` except its ``/metrics`` half.

Where the reference test can, the reference's engine and the port's run
the same scenario on the same weights (crossed through ``interop``; each
side swaps to an artifact it sealed itself, of the same weights) and
must agree after every step on each lane's generation and on
``weight_generations_held``, and at the end on every stream, the swap
report and the swap counters. The port is also held to the reference
test's own oracle: a stream admitted before the flip equals, bitwise, a
run that never swapped, and one admitted after it a run that served the
new weights from the start; a corrupt artifact never flips; a quarantine
spike on the new generation rolls back, one on the old generation does
not; a crash inside the window recovers every stream on its own weights;
the asyncio front door swaps while a stream is in flight. Streams,
generations, counters and states are compared bitwise (tiny_cfg, f32
weights)."""
import asyncio
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import tiny_cfg  # noqa: E402
from repro.core import sparse_mlp as jsm, topk  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import artifact as jart, export as jexport  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import recovery as jrecovery  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.serving import artifact as tart, hotswap  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import recovery as trecovery  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.frontend import AsyncEngine  # noqa: E402
from test_torch_train import port_cfg  # noqa: E402

KW = dict(max_batch=4, max_len=48, slab_k=4, page_size=8)
MODES = {"phased": {}, "mixed": dict(mixed=True),
         "prefix": dict(prefix_cache=True), "contiguous": dict(paged=False)}
SWAP_STATS = ("weight_swaps", "swap_canary_failures", "swap_rollbacks",
              "swap_canary_tokens", "swap_quarantines", "weight_generation",
              "weight_generations_held", "generated_tokens", "admitted",
              "evicted", "lanes_quarantined", "recoveries",
              "re_prefilled_tokens", "recovered_zero_reprefill")


def _masks(cfg, params):
    masks = {}
    for path in jreg.sparse_paths(cfg):
        w = jsm.get_path(params, path)
        bi, bo = jsm.block_dims_for(cfg.blast, path)

        def mk(wi):
            s = topk.block_norms(wi, bi, bo)
            return topk.topk_mask_per_col(
                s, max(1, (wi.shape[-2] // bi) // 2))

        fn = mk
        for _ in range(w.ndim - 2):
            fn = jax.vmap(fn)
        masks[path] = fn(w)
    return masks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Old and new packed weights on both sides, and each side's sealed
    artifacts of them."""
    jcfg = tiny_cfg()
    tcfg = port_cfg(jcfg)
    p_old = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    p_new = jreg.init_params(jcfg, jax.random.PRNGKey(7))
    masks = _masks(jcfg, p_old)
    j_old = jexport.pack_params(jcfg, p_old, masks, dtype=jnp.float32)
    j_new = jexport.pack_params(jcfg, p_new, masks, dtype=jnp.float32)
    t_old, t_new = (interop.to_torch(jax.device_get(p), device="cpu")
                    for p in (j_old, j_new))
    d = tmp_path_factory.mktemp("artifacts")
    arts = {}
    for side, seal, cfg, olds, news in (
            ("jax", jart.seal, jcfg, j_old, j_new),
            ("port", tart.seal, tcfg, t_old, t_new)):
        for name, p in (("old", olds), ("new", news)):
            arts[side, name] = str(d / f"{side}_{name}")
            seal(cfg, p, arts[side, name])
    return dict(jcfg=jcfg, tcfg=tcfg, j_old=j_old, j_new=j_new,
                t_old=t_old, t_new=t_new, arts=arts)


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
            for n in lens]


def _busy(eng):
    return bool(len(eng.scheduler) or eng.active_lanes or eng._preempted
                or eng._pending_results)


def _drain(eng, out=None):
    out = {} if out is None else out
    steps = 0
    while _busy(eng):
        for r in eng.step():
            out[r.uid] = r
        steps += 1
        assert steps < 500
    return out


def _port(w, params, **kw):
    return TEngine(w["tcfg"], params, device="cpu", **dict(KW, **kw))


def _base(w, params, prompts, n_tok, **kw):
    eng = _port(w, params, **kw)
    for p in prompts:
        eng.submit(p, n_tok)
    return _drain(eng)


def _side(w, side):
    """(engine factory, old params, new-weights artifact) of one side."""
    if side == "jax":
        return ((lambda p, **kw: JEngine(w["jcfg"], p, **dict(KW, **kw))),
                w["j_old"], w["arts"]["jax", "new"])
    return ((lambda p, **kw: _port(w, p, **kw)), w["t_old"],
            w["arts"]["port", "new"])


def _trace(eng):
    return (eng.stats["weight_generations_held"], len(eng._gen_params),
            eng._gen, sorted((i, eng.lanes[i].gen)
                             for i in eng.active_lanes))


def _swap_run(w, side, prompts, n_tok, mode, swap_at=1, monitor=3):
    """Two requests, a swap before step ``swap_at``, two more after it;
    returns (results, per-step trace, report, stats)."""
    make, old, art = _side(w, side)
    eng = make(old, **mode)
    for p in prompts[:2]:
        eng.submit(p, n_tok)
    out, trace, rep, step = {}, [], None, 0
    while _busy(eng) or step <= swap_at:
        if step == swap_at:
            rep = eng.swap_weights(art, monitor_steps=monitor)
            for p in prompts[2:]:
                eng.submit(p, n_tok)
        for r in eng.step():
            assert r.error is None, r.error
            out[r.uid] = r
        trace.append(_trace(eng))
        step += 1
        assert step < 500
    return out, trace, rep, eng


def _same_report(t, j):
    for k in ("state", "from_gen", "to_gen", "fingerprint", "monitor_steps",
              "quarantines", "rollback_reason", "rollback_gen"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.canary["token_mismatches"] == j.canary["token_mismatches"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mid_stream_swap_bitwise_oracle(world, mode):
    """Swap mid-decode while two lanes stream; two more admit after the
    flip. Both engines agree step by step; the port's pre-flip streams
    equal its no-swap run and its post-flip ones its new-weights run,
    bitwise; nothing is dropped and the old weights are freed."""
    w = world
    kw = MODES[mode]
    prompts = _prompts(w["jcfg"], (6, 8, 5, 7))
    jout, jtrace, jrep, je = _swap_run(w, "jax", prompts, 16, kw)
    tout, ttrace, trep, te = _swap_run(w, "port", prompts, 16, kw)
    assert ttrace == jtrace
    assert sorted(tout) == sorted(jout) == [0, 1, 2, 3]
    for u in tout:
        np.testing.assert_array_equal(tout[u].generated, jout[u].generated)
    _same_report(trep, jrep)
    assert trep.state == hotswap.COMMITTED
    for k in SWAP_STATS:
        assert te.stats[k] == je.stats[k], k
    base_old = _base(w, w["t_old"], prompts, 16, **kw)
    base_new = _base(w, w["t_new"], prompts, 16, **kw)
    for u in (0, 1):
        np.testing.assert_array_equal(tout[u].generated,
                                      base_old[u].generated)
    for u in (2, 3):
        np.testing.assert_array_equal(tout[u].generated,
                                      base_new[u].generated)
    assert {g for _, _, _, lanes in ttrace for _, g in lanes} == {0, 1}
    assert max(h for h, *_ in ttrace) == 2
    assert len(te._gen_params) == 1 and te._gen in te._gen_params
    assert te.params is te._gen_params[1]


def test_mixed_swap_window_counts_no_stall(world):
    """The mixed engine's promise holds across a swap window: a live lane
    that decodes in the other generation's call of the same step is not
    stalled. The port counts 0 stalled decode steps, as its no-swap run
    does; the reference counts a stall for each split call that carries
    a chunk while the other generation's lanes decode (its fault)."""
    w = world
    kw = MODES["mixed"]
    prompts = _prompts(w["jcfg"], (6, 8, 5, 7))
    _, _, _, je = _swap_run(w, "jax", prompts, 16, kw)
    _, _, trep, te = _swap_run(w, "port", prompts, 16, kw)
    assert trep.state == hotswap.COMMITTED
    base = _port(w, w["t_old"], **kw)
    for p in prompts:
        base.submit(p, 16)
    _drain(base)
    assert base.stats["stalled_decode_steps"] == 0
    assert te.stats["stalled_decode_steps"] == 0
    assert je.stats["stalled_decode_steps"] > 0


def test_swap_idle_engine_and_double_swap(world):
    w = world
    eng = _port(w, w["t_old"])
    rep1 = eng.swap_weights(w["arts"]["port", "new"], monitor_steps=1)
    with pytest.raises(RuntimeError, match="monitoring window"):
        eng.swap_weights(w["arts"]["port", "old"])
    eng.submit(_prompts(w["jcfg"], (6,))[0], 8)
    out = _drain(eng)
    assert rep1.state == hotswap.COMMITTED
    rep2 = eng.swap_weights(w["arts"]["port", "old"], monitor_steps=1)
    eng.submit(_prompts(w["jcfg"], (6,))[0], 8)
    _drain(eng, out)
    assert rep2.to_gen == 2 and rep2.state == hotswap.COMMITTED
    base_old = _base(w, w["t_old"], _prompts(w["jcfg"], (6,)), 8)
    base_new = _base(w, w["t_new"], _prompts(w["jcfg"], (6,)), 8)
    np.testing.assert_array_equal(out[0].generated, base_new[0].generated)
    np.testing.assert_array_equal(out[1].generated, base_old[0].generated)


@pytest.mark.parametrize("kind", ["block_bitflip", "idx_oob_signed",
                                  "canary_weights_signed"])
def test_corrupt_artifact_never_flips(world, tmp_path, kind):
    """The swap raises the corruption's typed error; the serving weights
    and generation are untouched and the stream in flight finishes as
    without the attempt."""
    w = world
    prompts = _prompts(w["jcfg"], (6,))
    base = _base(w, w["t_old"], prompts, 8)
    cp = str(tmp_path / kind)
    shutil.copytree(w["arts"]["port", "new"], cp)
    expected = tfaults.FaultPlan().on_artifact(cp, kind)
    eng = _port(w, w["t_old"], max_batch=2)
    eng.submit(prompts[0], 8)
    eng.step()
    with pytest.raises(expected):
        eng.swap_weights(cp)
    assert eng._gen == 0 and eng.params is w["t_old"]
    assert eng._swap_monitor is None and list(eng._gen_params) == [0]
    out = _drain(eng)
    np.testing.assert_array_equal(out[0].generated, base[0].generated)
    assert eng.stats["weight_swaps"] == 0
    assert eng.stats["swap_canary_failures"] == int(
        kind == "canary_weights_signed")


def _poison_run(w, side, target):
    """Request 0 on the old weights, a swap, request 1 on the new ones;
    then the ``target`` generation's lane ("new" or "old") is poisoned.
    Returns (results, report, engine, per-step trace)."""
    make, old, art = _side(w, side)
    prompts = _prompts(w["jcfg"], (6, 8))
    eng = make(old)
    eng.submit(prompts[0], 16)
    eng.step()
    old_lane = eng.active_lanes[0]
    rep = eng.swap_weights(art, monitor_steps=8 if target == "new" else 4,
                           quarantine_limit=0)
    bad_gen = eng._gen
    if target == "new":
        eng.submit(prompts[1], 16)
        eng.step()
        lane = next(i for i in eng.active_lanes
                    if eng.lanes[i].gen == bad_gen)
    else:
        lane = old_lane
    eng._mirror["poison"][lane] = np.inf
    eng._dirty = True
    out, trace = {}, []
    while _busy(eng) or eng._swap_monitor is not None:
        for r in eng.step():
            out[r.uid] = r
        trace.append(_trace(eng))
        assert len(trace) < 500
    return out, rep, eng, trace


def test_quarantine_spike_rolls_back(world):
    """A quarantine on the new generation inside the window rolls back to
    the previous weights as a fresh generation; the old-generation stream
    finishes untouched. The reference's engine does the same."""
    w = world
    tout, trep, te, ttrace = _poison_run(w, "port", "new")
    jout, jrep, je, jtrace = _poison_run(w, "jax", "new")
    assert ttrace == jtrace
    _same_report(trep, jrep)
    assert trep.state == hotswap.ROLLED_BACK
    assert trep.rollback_reason == "quarantine_spike"
    assert te.params is w["t_old"] and te._gen == trep.rollback_gen == 2
    for k in SWAP_STATS:
        assert te.stats[k] == je.stats[k], k
    assert te.stats["swap_rollbacks"] == te.stats["swap_quarantines"] == 1
    base = _base(w, w["t_old"], _prompts(w["jcfg"], (6,)), 16)
    assert tout[0].ok
    np.testing.assert_array_equal(tout[0].generated, base[0].generated)
    assert type(tout[1].error).__name__ == type(jout[1].error).__name__ \
        == "LaneFaultError"
    assert te._swap_monitor is None


def test_old_gen_quarantine_does_not_rollback(world):
    w = world
    tout, trep, te, ttrace = _poison_run(w, "port", "old")
    jout, jrep, je, jtrace = _poison_run(w, "jax", "old")
    assert ttrace == jtrace
    _same_report(trep, jrep)
    assert not tout[0].ok and not jout[0].ok
    assert trep.state == hotswap.COMMITTED
    for k in SWAP_STATS:
        assert te.stats[k] == je.stats[k], k
    assert te.stats["swap_rollbacks"] == te.stats["swap_quarantines"] == 0


def _crash_run(w, side, device_lost):
    make, old, art = _side(w, side)
    plan_mod, sup = ((jfaults, jrecovery.Supervisor) if side == "jax"
                     else (tfaults, trecovery.Supervisor))
    prompts = _prompts(w["jcfg"], (6, 8, 5, 7))
    eng = make(old)
    for p in prompts[:2]:
        eng.submit(p, 16)
    eng.step()
    rep = eng.swap_weights(art, monitor_steps=50)
    for p in prompts[2:]:
        eng.submit(p, 16)
    eng.step()
    assert {eng.lanes[i].gen for i in eng.active_lanes} == {0, 1}
    eng.install_faults(plan_mod.FaultPlan().crash(
        eng._step_idx, device_lost=device_lost))
    with pytest.raises(plan_mod.EngineCrashError):
        eng.step()
    summary = sup(eng).recover(
        plan_mod.EngineCrashError("crash", device_lost=device_lost))
    pins = dict(eng._gen_pins)
    salvaged = sorted((p.req.uid, p.gen) for p in eng._preempted)
    out = _drain(eng)
    return out, rep, eng, pins, salvaged, summary


@pytest.mark.parametrize("device_lost", [True, False],
                         ids=["device_lost", "host_crash"])
def test_crash_mid_window_recovers_per_generation(world, device_lost):
    """The stepper crashes while lanes of two generations are in flight.
    Relaunches (device lost) are pinned, and salvaged lanes (host crash)
    restored, on their admission-time generation, so every stream
    finishes equal to its own weights' run; both engines agree."""
    w = world
    tout, trep, te, tpins, tsalv, tsum = _crash_run(w, "port", device_lost)
    jout, jrep, je, jpins, jsalv, jsum = _crash_run(w, "jax", device_lost)
    assert tpins == jpins and tsalv == jsalv
    assert (tsum["salvaged_lanes"], tsum["relaunched_lanes"]) == \
        (jsum["salvaged_lanes"], jsum["relaunched_lanes"])
    if device_lost:
        assert set(tpins.values()) == {0, 1} and not tsalv
    else:
        assert {g for _, g in tsalv} == {0, 1} and not tpins
    prompts = _prompts(w["jcfg"], (6, 8, 5, 7))
    base_old = _base(w, w["t_old"], prompts, 16)
    base_new = _base(w, w["t_new"], prompts, 16)
    for u, base in ((0, base_old), (1, base_old), (2, base_new),
                    (3, base_new)):
        assert tout[u].ok, tout[u].error
        np.testing.assert_array_equal(tout[u].generated, base[u].generated)
        np.testing.assert_array_equal(tout[u].generated, jout[u].generated)
    _same_report(trep, jrep)
    assert trep.state in (hotswap.FLIPPED, hotswap.COMMITTED)
    assert len(te._gen_params) == 1 and not te._gen_pins
    for k in SWAP_STATS:
        assert te.stats[k] == je.stats[k], k


def test_async_swap_keeps_streams(world):
    """Behind the asyncio front door the swap runs between steps while a
    stream is mid-decode; that stream finishes on the old weights and the
    next one on the new."""
    w = world
    prompts = _prompts(w["jcfg"], (6, 8))
    base_old = _base(w, w["t_old"], prompts, 12)
    base_new = _base(w, w["t_new"], prompts, 12)

    async def drive():
        eng = _port(w, w["t_old"])
        async with AsyncEngine(eng) as front:
            s0 = await front.submit_async(prompts[0], 12)
            await s0.__anext__()
            rep = await front.swap_weights_async(
                w["arts"]["port", "new"], monitor_steps=2)
            s1 = await front.submit_async(prompts[1], 12)
            return eng, rep, await s0.result(), await s1.result()

    eng, rep, r0, r1 = asyncio.run(asyncio.wait_for(drive(), 120))
    np.testing.assert_array_equal(r0.generated, base_old[0].generated)
    np.testing.assert_array_equal(r1.generated, base_new[1].generated)
    assert rep.state in (hotswap.FLIPPED, hotswap.COMMITTED)
    assert eng.stats["weight_swaps"] == 1 and eng._gen == 1


def test_async_swap_rejects_corrupt_artifact(world, tmp_path):
    w = world
    cp = str(tmp_path / "bad")
    shutil.copytree(w["arts"]["port", "new"], cp)
    expected = tfaults.FaultPlan().on_artifact(cp, "idx_bitflip")

    async def drive():
        eng = _port(w, w["t_old"], max_batch=2)
        async with AsyncEngine(eng) as front:
            s = await front.submit_async(_prompts(w["jcfg"], (6,))[0], 8)
            with pytest.raises(expected):
                await front.swap_weights_async(cp)
            await s.result()
        return eng

    eng = asyncio.run(asyncio.wait_for(drive(), 120))
    assert eng._gen == 0 and eng.stats["weight_swaps"] == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_split_slab_leaves_masked_lanes_bitwise(world, paged):
    """The port writes its caches in place: a slab call of one generation
    must leave every lane of the other generation, masked out of it,
    with its KV rows, pending token, frontier, budget and fault flag
    bitwise unchanged."""
    from test_torch_hotswap_gpu import check_split_calls, split_slab_calls
    w = world
    calls, eng = split_slab_calls(w["tcfg"], w["t_old"], w["t_new"], "cpu",
                                  paged=paged)
    check_split_calls(calls)
    assert {eng.lanes[i].gen for i in eng.active_lanes} == {0, 1}
