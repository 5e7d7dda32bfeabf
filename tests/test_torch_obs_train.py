"""The trainer's observability in the port (``train_loop.train(tracer=,
metrics=)``, the guard's and the checkpointer's tracer) against the
reference loop's:

  * tracing on leaves the ``TrainState`` bitwise equal to the untraced
    run, with one ``train.step`` span per step whose duration is the
    step's ``sec_per_step``;
  * from one shared initial state and the same ``TrainFaultPlan`` (NaN
    gradients that trip a rewind, then a divergence), the port's ring
    holds the reference's sequence of ``train.*`` and ``ckpt.*`` records
    (names and attrs; losses to rel 1e-5 at the learning rate of the
    multi-step parity tests, 1e-4; NaN equals NaN), and the
    ``train_rewind`` and ``training_diverged`` postmortems carry the
    reference's meta and frozen records;
  * the loop's counters on an injected ``MetricsRegistry`` give the
    reference's Prometheus text byte for byte;
  * the ``Checkpointer`` records ``ckpt.save`` (blocking or not) and
    ``ckpt.restore`` spans, and ``ckpt.fallback`` past a torn checkpoint,
    as the reference's does on the same files."""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import tiny_cfg  # noqa: E402
from repro.checkpointing.checkpoint import Checkpointer as JCkpt  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import faults as jfaults  # noqa: E402
from repro.training import step as jts, train_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpointing.checkpoint import Checkpointer  # noqa: E402
from repro_torch.obs.metrics import (MetricsRegistry,  # noqa: E402
                                     parse_prometheus_text)
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import faults as tf  # noqa: E402
from repro_torch.training import guard as tguard  # noqa: E402
from repro_torch.training import train_loop as tloop  # noqa: E402
from test_torch_train import port_cfg  # noqa: E402

TIMED = ("sec_per_step", "median_s")


def _opt(mod, lr=1e-4):
    return mod.AdamWConfig(peak_lr=lr, warmup_steps=5, total_steps=60,
                           weight_decay=0.0)


def _leaves(s):
    return tadam.tree_leaves({"p": s.params, "o": s.opt_state,
                              "m": s.masks})


def test_tracing_on_leaves_the_train_state_bitwise():
    cfg = port_cfg(tiny_cfg())

    def run(tracer):
        src = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=16,
                          seed=3)
        loop = tloop.TrainLoopConfig(total_steps=8, log_every=4)
        hist = []
        state, _ = tloop.train(cfg, _opt(tadam, 2e-2), src, loop,
                               log_fn=hist.append, tracer=tracer,
                               device="cpu")
        return state, hist

    sa, ha = run(None)
    tr = Tracer()
    sb, hb = run(tr)
    assert sa.step == sb.step == 8
    for a, b in zip(_leaves(sa), _leaves(sb)):
        assert torch.equal(a, b)
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    steps = [s for s in tr.records if s.name == "train.step"]
    assert [s.attrs["step"] for s in steps] == list(range(8))
    assert all(s.dur > 0 and s.attrs["anomaly"] is False for s in steps)
    logged = {m["step"]: m for m in hb if "event" not in m}
    assert sorted(logged) == [0, 4, 7]
    for s in steps:
        if s.attrs["step"] in logged:
            m = logged[s.attrs["step"]]
            assert s.dur == m["sec_per_step"] and s.attrs["loss"] == m["loss"]
    for m, n in zip(ha, hb):
        if "event" not in m:
            assert m["loss"] == n["loss"]


@pytest.mark.parametrize("blast", [True, False])
def test_train_step_span_ends_at_the_metrics_read(monkeypatch, blast):
    """At every step, logged or not (``log_every`` 4), the ``train.step``
    span starts before the step is called and ends after the step's
    ``sparsity`` was read (the device scalar made after the update, with
    or without BLaST)."""
    import time
    cfg = port_cfg(tiny_cfg())
    if not blast:
        cfg = dataclasses.replace(cfg, blast=dataclasses.replace(
            cfg.blast, enabled=False))
    called, read = [], []

    class Clocked:
        def __init__(self, v):
            assert isinstance(v, torch.Tensor)
            self.v = v

        def __float__(self):
            read.append(time.monotonic())
            return float(self.v)

    make = tloop.step_mod.make_train_step

    def clocked(*a, **kw):
        fn = make(*a, **kw)

        def step(state, batch):
            called.append(time.monotonic())
            new, out = fn(state, batch)
            return new, dict(out, sparsity=Clocked(out["sparsity"]))
        return step

    monkeypatch.setattr(tloop.step_mod, "make_train_step", clocked)
    src = SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    tr = Tracer()
    tloop.train(cfg, _opt(tadam), src,
                tloop.TrainLoopConfig(total_steps=10, log_every=4),
                log_fn=lambda m: None, tracer=tr, device="cpu")
    spans = [s for s in tr.records if s.name == "train.step"]
    assert [s.attrs["step"] for s in spans] == list(range(10))
    assert len(called) == len(read) == 10
    for s, c, r in zip(spans, called, read):
        assert s.t0 <= c and r <= s.t1


def _rewind_plan(mod):
    # NaN at 5, 6, 7: the guard rewinds at 7 to the checkpoint at 4; NaN
    # at 9, 10, 11 spends the budget of one rewind
    p = mod.TrainFaultPlan()
    for s in (5, 6, 7, 9, 10, 11):
        p.nan_grads(s)
    return p


@pytest.fixture(scope="module")
def rewind(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_rewind")
    jcfg = tiny_cfg()
    src = SyntheticLM(jcfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    gkw = dict(warmup_steps=3, max_consecutive=3, max_rewinds=1)
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    tstate = interop.train_state(jax.device_get(js), device="cpu")
    jl = jloop.TrainLoopConfig(
        total_steps=16, log_every=2, straggler_factor=1e9,
        ckpt_dir=str(tmp / "j"), ckpt_every=4,
        guard=jloop.GuardConfig(**gkw))
    tl = tloop.TrainLoopConfig(
        total_steps=16, log_every=2, straggler_factor=1e9,
        ckpt_dir=str(tmp / "t"), ckpt_every=4,
        guard=tguard.GuardConfig(**gkw))
    jt, tt = JTracer(postmortem_dir=str(tmp / "pm_j")), Tracer(
        postmortem_dir=str(tmp / "pm_t"))
    jreg, treg = JRegistry(namespace="blast_train"), MetricsRegistry(
        namespace="blast_train")
    # the reference asks for the rewind target without joining the
    # step-4 write in flight, so under load it may find no checkpoint;
    # held here to the port's rule (join first) for its run only
    latest = JCkpt.latest_intact_step

    def joined(self):
        self.wait()
        return latest(self)

    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(jfaults.TrainingDivergedError):
        mp.setattr(JCkpt, "latest_intact_step", joined)
        jloop.train(jcfg, _opt(jadam), src, jl, state=js,
                    faults=_rewind_plan(jfaults), log_fn=lambda m: None,
                    tracer=jt, metrics=jreg)
    with pytest.raises(tf.TrainingDivergedError):
        tloop.train(port_cfg(jcfg), _opt(tadam), src, tl, state=tstate,
                    faults=_rewind_plan(tf), log_fn=lambda m: None,
                    tracer=tt, metrics=treg)
    return dict(jt=jt, tt=tt, jreg=jreg, treg=treg, tmp=tmp,
                tstate=tstate, src=src, gkw=gkw)


def _same(g, w, where):
    if isinstance(w, float) and isinstance(g, float):
        if math.isnan(w):
            assert math.isnan(g), where
        else:
            assert g == pytest.approx(w, rel=1e-5), where
    else:
        assert g == w, where


def _same_records(got, want):
    def strip(spans):
        out = []
        for s in spans:
            name, attrs = ((s["name"], s["attrs"]) if isinstance(s, dict)
                           else (s.name, s.attrs))
            out.append((name, {k: v for k, v in attrs.items()
                               if k not in TIMED}))
        return out

    got, want = strip(got), strip(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for i, ((n, g), (_, w)) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (i, n)
        for k in w:
            _same(g[k], w[k], (i, n, k))


def test_train_records_equal_the_reference(rewind):
    tt, jt = rewind["tt"], rewind["jt"]
    _same_records(list(tt.records), list(jt.records))
    names = [s.name for s in tt.records]
    for n in ("train.step", "train.anomaly", "train.rewind", "ckpt.save",
              "ckpt.restore"):
        assert n in names, n
    anomalies = [s.attrs for s in tt.records if s.name == "train.anomaly"]
    assert [a["step"] for a in anomalies] == [5, 6, 7, 9, 10, 11]
    assert all(a["verdict"] == "skip" for a in anomalies)
    rw = [s.attrs for s in tt.records if s.name == "train.rewind"]
    assert rw == [dict(step=7, to_step=4, consecutive=3)]
    # every step run, the replayed ones included, has its span
    steps = [s.attrs["step"] for s in tt.records if s.name == "train.step"]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 7, 4, 5, 6, 7, 8, 9, 10, 11]


def test_rewind_and_divergence_postmortems(rewind):
    tt, jt = rewind["tt"], rewind["jt"]
    reasons = [p["reason"] for p in tt.postmortems]
    assert reasons == ["train_rewind", "training_diverged"]
    assert reasons == [p["reason"] for p in jt.postmortems]
    for g, w in zip(tt.postmortems, jt.postmortems):
        assert g["meta"] == w["meta"]
        _same_records(g["spans"], w["spans"])
    rw = tt.postmortems[0]
    assert rw["meta"] == dict(step=7, consecutive=3, rewinds=0)
    # frozen before the restore: the anomalous run-up, no ckpt.restore
    assert rw["spans"][-1]["name"] == "train.anomaly"
    assert "ckpt.restore" not in [s["name"] for s in rw["spans"]]
    files = sorted(os.listdir(rewind["tmp"] / "pm_t"))
    assert files == ["postmortem_0000_train_rewind.json",
                     "postmortem_0001_training_diverged.json"]


def test_rewind_waits_for_a_slow_checkpoint_write(rewind, monkeypatch):
    """The step-4 checkpoint's background write still runs when the
    guard asks to rewind at step 7 (every checksum of a write thread
    sleeps 0.2 s, so the write outlasts the three steps several times
    over): the loop joins it first, rewinds to step 4 and records what
    the reference records."""
    import threading
    import time

    from repro_torch.checkpointing import checkpoint as ckmod
    crc, slowed = ckmod.crc32_array, []

    def slow(a):
        if threading.current_thread() is not threading.main_thread():
            slowed.append(1)
            time.sleep(0.2)
        return crc(a)

    monkeypatch.setattr(ckmod, "crc32_array", slow)
    tmp = rewind["tmp"]
    tl = tloop.TrainLoopConfig(
        total_steps=16, log_every=2, straggler_factor=1e9,
        ckpt_dir=str(tmp / "t_slow"), ckpt_every=4,
        guard=tguard.GuardConfig(**rewind["gkw"]))
    tt, treg = Tracer(postmortem_dir=str(tmp / "pm_slow")), \
        MetricsRegistry(namespace="blast_train")
    with pytest.raises(tf.TrainingDivergedError):
        tloop.train(port_cfg(tiny_cfg()), _opt(tadam), rewind["src"], tl,
                    state=rewind["tstate"], faults=_rewind_plan(tf),
                    log_fn=lambda m: None, tracer=tt, metrics=treg)
    assert slowed
    rw = [s.attrs for s in tt.records if s.name == "train.rewind"]
    assert rw == [dict(step=7, to_step=4, consecutive=3)]
    _same_records(list(tt.records), list(rewind["jt"].records))
    assert treg.prometheus_text() == rewind["jreg"].prometheus_text()


def test_train_counters_prometheus_byte_equal(rewind):
    text = rewind["treg"].prometheus_text()
    assert text == rewind["jreg"].prometheus_text()
    parsed = parse_prometheus_text(text)
    assert parsed["blast_train_rewinds"] == 1
    assert parsed["blast_train_skipped_steps"] == 6
    assert parsed["blast_train_steps_replayed"] == 3
    assert sorted(rewind["treg"].names()) == sorted(tloop.COUNTERS)


def _state(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g), "b": np.arange(5)}


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpointer_spans(tmp_path, blocking):
    tr = Tracer()
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.tracer = tr
    ck.save(4, _state(), blocking=blocking)
    ck.wait()
    tree = ck.restore(_state(1))
    assert torch.equal(tree["w"], _state()["w"])
    ck.restore(_state(1), step=4)
    assert [(s.name, s.attrs) for s in tr.records] == [
        ("ckpt.save", dict(step=4, blocking=blocking)),
        ("ckpt.restore", dict(step=-1)), ("ckpt.restore", dict(step=4))]
    assert all(s.dur > 0 for s in tr.records)


def test_checkpoint_fallback_event_equals_the_reference(tmp_path):
    """Three checkpoints, the newest two torn: restore falls back past
    both, one ``ckpt.fallback`` inside the ``ckpt.restore`` span, on both
    packages' checkpointers over the same files; a corrupt explicit step
    leaves the error's name in the span."""
    ck = Checkpointer(str(tmp_path))
    for s in (2, 4, 6):
        ck.save(s, _state(s), blocking=True)
    for s in (4, 6):
        d = tmp_path / f"step_{s:08d}" / "arrays.npz"
        d.write_bytes(d.read_bytes()[:40])
    recs = {}
    for side, cls, tcls in (("port", Checkpointer, Tracer),
                            ("jax", JCkpt, JTracer)):
        tr = tcls()
        c = cls(str(tmp_path))
        c.tracer = tr
        tmpl = ({"w": np.zeros((4, 3), np.float32), "b": np.zeros(5, int)}
                if side == "jax" else _state(9))
        c.restore(tmpl)
        assert c.fallbacks == 2
        with pytest.raises(Exception) as e:
            c.restore(tmpl, step=6)
        assert type(e.value).__name__ == "CheckpointCorruptionError"
        recs[side] = [(s.name, s.attrs) for s in tr.records]
    assert recs["port"] == recs["jax"] == [
        ("ckpt.fallback", dict(skipped=2, to_step=2)),
        ("ckpt.restore", dict(step=-1)),
        ("ckpt.restore", dict(step=6, error="CheckpointCorruptionError"))]


def test_chaos_child_traces_a_rewind(tmp_path):
    """The chaos child with a ``trace_dir`` (what ``chip_smoke.py`` runs on
    the card), here on the CPU: NaN gradients at 5, 6 and 7 rewind to step
    4; the metadata holds one ``train_rewind`` postmortem, written to the
    directory, whose records hold the three anomalies, and a span per
    step run."""
    pm = tmp_path / "pm"
    spec = tf.default_chaos_spec(str(tmp_path), ckpt_dir=str(tmp_path / "ck"),
                                 steps=8, nan_at=[5, 6, 7], device="cpu",
                                 trace_dir=str(pm))
    r = tf.run_child(spec, str(tmp_path / "spec.json"), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    meta = json.loads((tmp_path / "meta.json").read_text())
    trace = meta["trace"]
    [p] = trace["postmortems"]
    assert p["reason"] == "train_rewind"
    assert p["meta"] == dict(step=7, consecutive=3, rewinds=0)
    assert p["names"].count("train.anomaly") == 3
    assert p["names"][-1] == "train.anomaly"
    assert trace["records"]["train.step"] == 12      # 8 + 4 replayed
    assert trace["records"]["train.rewind"] == 1
    assert len(trace["train_step_s"]) == 12
    assert meta["counters"]["rewinds"] == 1
    assert sorted(os.listdir(pm)) == ["postmortem_0000_train_rewind.json"]


def test_chaos_child_traced_pair_is_bitwise(tmp_path):
    """Two chaos children train the same 4 steps, one untraced and one
    with a ``trace_dir`` (the pair ``chip_smoke.py`` runs on the card):
    every final leaf is bitwise equal."""
    import json
    out = {}
    for name, trace_dir in (("off", None), ("on", str(tmp_path / "pm"))):
        d = tmp_path / name
        d.mkdir()
        spec = tf.default_chaos_spec(str(d), steps=4, device="cpu",
                                     trace_dir=trace_dir)
        r = tf.run_child(spec, str(d / "spec.json"), timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        out[name] = (json.loads((d / "meta.json").read_text()),
                     dict(np.load(spec["out"])))
    (m_off, off), (m_on, on) = out["off"], out["on"]
    assert m_off["trace"] is None
    assert m_on["trace"]["records"] == {"train.step": 4}
    assert m_on["trace"]["postmortems"] == []
    assert sorted(off) == sorted(on) and len(on) > 10
    assert [k for k in on if not np.array_equal(on[k], off[k])] == []
