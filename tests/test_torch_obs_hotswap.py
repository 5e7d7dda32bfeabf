"""The hot-swap's spans, events and postmortems and the front door's
``/metrics`` endpoint in the port, against the reference's
``tests/test_hotswap.py`` cases (``world``: the same old and new weights
on both sides, each side swapping to an artifact it sealed itself):

  * a quarantine spike on the new generation rolls back with a
    ``swap.rollback`` span and postmortem whose meta and frozen spans
    equal the reference's; a swap that commits records ``swap.stage``,
    ``swap.canary``, ``swap.flip`` and ``swap.commit`` in the reference's
    order with its attrs;
  * a corrupt artifact leaves ``swap.validate_failure`` and a canary
    that fails its gate ``swap.canary_failure`` (with a failed
    ``swap.canary`` span), as in the reference;
  * ``AsyncEngine(eng, metrics_port=0)`` serves the engine's registry as
    Prometheus text on ``/metrics`` while a swap runs behind it (the
    port's twin of ``test_async_swap_and_metrics_endpoint``): both
    packages' parsers read it, it equals the registry at the scrape,
    ``/nope`` is a 404, and the endpoint closes with the front door.

Spans compare as (name, attrs) without seconds; the ``artifact`` attr
names each side's own directory."""
import asyncio
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.obs.metrics import parse_prometheus_text as jparse  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch.obs.metrics import (Histogram,  # noqa: E402
                                     parse_prometheus_text)
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import hotswap  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.frontend import AsyncEngine  # noqa: E402
from test_torch_hotswap import (_base, _busy, _port,  # noqa: E402,F401
                                _prompts, _side, world)


def _events(spans, art):
    out = []
    for name, attrs in ts.events(spans):
        if "artifact" in attrs:
            assert attrs.pop("artifact") == art
        out.append((name, attrs))
    return out


def _swap_side(w, side, target, monitor=8):
    """Request 0 on the old weights, a swap, request 1 on the new ones,
    then the ``target`` generation's lane poisoned ("new": rollback;
    None: no poison, the swap commits). Returns (tracer, report, engine,
    artifact, results)."""
    make, old, art = _side(w, side)
    tr = JTracer() if side == "jax" else Tracer()
    prompts = _prompts(w["jcfg"], (6, 8))
    eng = make(old, tracer=tr)
    eng.submit(prompts[0], 16)
    eng.step()
    rep = eng.swap_weights(art, monitor_steps=monitor, quarantine_limit=0)
    eng.submit(prompts[1], 16)
    eng.step()
    if target == "new":
        lane = next(i for i in eng.active_lanes
                    if eng.lanes[i].gen == eng._gen)
        eng._mirror["poison"][lane] = np.inf
        eng._dirty = True
    out, n = {}, 0
    while _busy(eng) or eng._swap_monitor is not None:
        out.update((r.uid, r) for r in eng.step())
        n += 1
        assert n < 500
    return tr, rep, eng, art, out


def test_rollback_postmortem_equals_the_reference(world):
    tt, trep, te, tart, tout = _swap_side(world, "port", "new")
    jt, jrep, je, jart, jout = _swap_side(world, "jax", "new")
    assert trep.state == hotswap.ROLLED_BACK
    assert [p["reason"] for p in tt.postmortems] == ["swap.rollback"]
    assert [p["reason"] for p in jt.postmortems] == ["swap.rollback"]
    pm, jpm = tt.postmortems[0], jt.postmortems[0]
    assert pm["meta"] == jpm["meta"]
    assert pm["meta"]["cause"] == "quarantine_spike"
    assert (pm["meta"]["bad_gen"], pm["meta"]["restored_gen"]) == (1, 2)
    assert _events(pm["spans"], tart) == _events(jpm["spans"], jart)
    # the victim, the new-generation lane, threads the frozen ring; the
    # dump froze inside its quarantine, whose event follows the rollback
    names = [s["name"] for s in pm["spans"] if s["attrs"].get("uid") == 1]
    assert names[0] == "request.queued" and "request.admitted" in names
    assert any(1 in (s["attrs"].get("uids") or ()) for s in pm["spans"]
               if s["name"] == "decode.slab")
    assert pm["spans"][-1]["name"] == "swap.rollback"
    after = [s.name for s in tt.records][len(pm["spans"]):]
    assert after[0] == "request.quarantined"
    assert _events(tt.records, tart) == _events(jt.records, jart)
    rb = [s for s in tt.records if s.name == "swap.rollback"]
    assert len(rb) == 1 and rb[0].attrs["reason"] == "quarantine_spike"
    assert not tout[1].ok and tout[0].ok


def test_committed_swap_spans_equal_the_reference(world):
    tt, trep, te, tart, _ = _swap_side(world, "port", None, monitor=3)
    jt, jrep, je, jart, _ = _swap_side(world, "jax", None, monitor=3)
    assert trep.state == hotswap.COMMITTED and tt.postmortems == []
    swap = [n for n, _ in _events(tt.records, tart) if n.startswith("swap.")]
    assert swap == ["swap.stage", "swap.canary", "swap.flip", "swap.commit"]
    assert _events(tt.records, tart) == _events(jt.records, jart)
    st = {s.name: s for s in tt.records}
    assert st["swap.canary"].attrs["passed"] is True
    assert st["swap.canary"].attrs["tokens"] == te.stats["swap_canary_tokens"]
    assert st["swap.flip"].attrs == dict(from_gen=0, to_gen=1,
                                         fingerprint=trep.fingerprint)
    # the report's stage and canary seconds are the spans' durations
    assert st["swap.stage"].dur == trep.stage_s
    assert st["swap.canary"].dur == trep.canary_s


@pytest.mark.parametrize("kind", ["block_bitflip", "idx_oob_signed",
                                  "canary_weights_signed"])
def test_failed_swap_postmortems(world, tmp_path, kind):
    w = world
    prompts = _prompts(w["jcfg"], (6,))
    reasons = {}
    for side, plan in (("port", tfaults.FaultPlan()),
                       ("jax", jfaults.FaultPlan())):
        make, old, art = _side(w, side)
        cp = str(tmp_path / f"{side}_{kind}")
        shutil.copytree(art, cp)
        expected = plan.on_artifact(cp, kind)
        tr = JTracer() if side == "jax" else Tracer()
        eng = make(old, max_batch=2, tracer=tr)
        eng.submit(prompts[0], 8)
        eng.step()
        with pytest.raises(expected):
            eng.swap_weights(cp)
        assert eng._gen == 0
        reasons[side] = [(p["reason"], p["meta"].get("error"))
                         for p in tr.postmortems]
        pm = tr.postmortems[-1]
        assert pm["meta"]["artifact"] == cp
        assert pm["spans"][0]["name"] == "request.queued"
        if side == "port":
            canary = [s for s in tr.records if s.name == "swap.canary"]
            stage = [s for s in tr.records if s.name == "swap.stage"]
    want = ("swap.canary_failure" if kind == "canary_weights_signed"
            else "swap.validate_failure")
    assert [r for r, _ in reasons["port"]] == [want]
    assert reasons["port"] == reasons["jax"]
    if kind == "canary_weights_signed":
        assert len(stage) == 1 and canary[0].attrs["passed"] is False
    else:
        assert stage == [] and canary == []


def test_async_swap_and_metrics_endpoint(world):
    w = world
    prompts = _prompts(w["jcfg"], (6, 8))
    base_old = _base(w, w["t_old"], prompts, 12)
    base_new = _base(w, w["t_new"], prompts, 12)

    async def drive():
        eng = _port(w, w["t_old"])
        async with AsyncEngine(eng, metrics_port=0) as front:
            s0 = await front.submit_async(prompts[0], 12)
            await s0.__anext__()              # s0 is mid-decode
            rep = await front.swap_weights_async(
                w["arts"]["port", "new"], monitor_steps=2)
            s1 = await front.submit_async(prompts[1], 12)
            r0, r1 = await s0.result(), await s1.result()
            host, port = front.metrics_addr
            url = f"http://{host}:{port}/metrics"
            loop = asyncio.get_running_loop()

            def get(u):
                with urllib.request.urlopen(u, timeout=10) as f:
                    return f.status, f.headers["Content-Type"], \
                        f.read().decode()

            # the engine is idle now: the registry holds still
            status, ctype, text = await loop.run_in_executor(None, get, url)
            snap = eng.metrics.snapshot()
            _, _, root = await loop.run_in_executor(
                None, get, f"http://{host}:{port}/")
            with pytest.raises(urllib.error.HTTPError) as e404:
                await loop.run_in_executor(
                    None, get, f"http://{host}:{port}/nope")
            return (eng, rep, r0, r1, status, ctype, text, root, snap, url,
                    e404.value.code)

    (eng, rep, r0, r1, status, ctype, text, root, snap, url,
     code) = asyncio.run(asyncio.wait_for(drive(), 120))
    np.testing.assert_array_equal(r0.generated, base_old[0].generated)
    np.testing.assert_array_equal(r1.generated, base_new[1].generated)
    assert rep.state in (hotswap.FLIPPED, hotswap.COMMITTED)
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert code == 404 and root == text
    parsed = parse_prometheus_text(text)
    assert parsed == jparse(text)
    assert parsed["blast_weight_swaps"] == 1.0
    assert parsed["blast_weight_generation"] == 1.0
    assert parsed["blast_swap_canary_tokens"] > 0
    for name, v in snap.items():
        if isinstance(eng.metrics[name], Histogram):
            assert parsed[f"blast_{name}_count"] == v["count"]
            assert parsed[f"blast_{name}_sum"] == v["sum"]
        else:
            assert parsed[f"blast_{name}"] == v, name
    assert parsed["blast_generated_tokens"] == eng.stats["generated_tokens"]
    with pytest.raises(urllib.error.URLError):     # closed with the door
        urllib.request.urlopen(url, timeout=2)
