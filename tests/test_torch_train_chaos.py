"""The port's training chaos harness (``repro_torch.training.faults``)
through the three cases of the reference's ``tests/test_train_chaos.py``:
a chaos child SIGKILLed mid-run resumes from its newest intact
checkpoint and ends bitwise where an uninterrupted child ends, across a
prune-and-grow refresh; a corrupted newest checkpoint is skipped and the
resumed run still ends bitwise as a clean one; the plan's nth-save
corruption leaves GC keeping the newest intact checkpoint. Then the
rewind: the port's loop and the reference's, from one shared initial
state with the same plan, rewind at the same step to the same
checkpoint, raise ``TrainingDivergedError`` at the same step once the
budget is spent, and log equal events and counters. Every comparison is
bitwise (the child trains on the CPU)."""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import faults as jfaults  # noqa: E402
from repro.training import step as jts, train_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpointing.checkpoint import Checkpointer  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import faults as tf  # noqa: E402
from repro_torch.training import guard as tguard  # noqa: E402
from repro_torch.training import train_loop as tloop  # noqa: E402
from test_torch_train import port_cfg  # noqa: E402


def _opt(mod):
    return mod.AdamWConfig(peak_lr=2e-2, warmup_steps=5, total_steps=60,
                           weight_decay=0.0)


def _run(steps, faults=None, state=None, **loop_kw):
    cfg = port_cfg(tiny_cfg())
    src = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=16, seed=3)
    loop = tloop.TrainLoopConfig(total_steps=steps, log_every=5, **loop_kw)
    return tloop.train(cfg, _opt(tadam), src, loop, faults=faults,
                       state=state, log_fn=lambda m: None, device="cpu")


def _leaves(s):
    return tadam.tree_leaves({"p": s.params, "o": s.opt_state,
                              "m": s.masks})


def test_sigkill_resume_bitwise_across_prune_boundary(tmp_path):
    """Child A is SIGKILLed at step 11 (newest checkpoint: 8); child A2
    resumes from 8 across the refresh at step 10; child B runs
    uninterrupted. A2's final state equals B's, leaf for leaf, generator
    included."""
    wd = str(tmp_path)
    ck = os.path.join(wd, "ck")
    spec_a = tf.default_chaos_spec(wd, ckpt_dir=ck, kill_at=11, device="cpu")
    ra = tf.run_child(spec_a, os.path.join(wd, "spec_a.json"))
    assert ra.returncode == -signal.SIGKILL, ra.stderr
    assert Checkpointer(ck).latest_intact_step() == 8

    spec_a2 = tf.default_chaos_spec(wd, ckpt_dir=ck, device="cpu")
    ra2 = tf.run_child(spec_a2, os.path.join(wd, "spec_a2.json"))
    assert ra2.returncode == 0, ra2.stderr
    with open(spec_a2["meta_out"]) as f:
        meta = json.load(f)
    assert meta["resumed_from"] == 8 and meta["nondeterministic_ops"] == []

    spec_b = tf.default_chaos_spec(
        wd, device="cpu", out=os.path.join(wd, "final_b.npz"),
        meta_out=os.path.join(wd, "meta_b.json"))
    rb = tf.run_child(spec_b, os.path.join(wd, "spec_b.json"))
    assert rb.returncode == 0, rb.stderr

    with np.load(spec_a2["out"]) as za, np.load(spec_b["out"]) as zb:
        assert set(za.files) == set(zb.files)
        assert int(za["step"]) == 16
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_corrupt_latest_falls_back_and_resume_matches_clean(tmp_path):
    d = str(tmp_path / "ck")
    _run(12, ckpt_dir=d, ckpt_every=4)              # saves 4, 8, 12
    f = os.path.join(d, "step_00000012", "arrays.npz")
    with open(f, "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        off = fh.tell() // 2
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 1]))
    assert Checkpointer(d).latest_intact_step() == 8

    state_a, hist = _run(20, ckpt_dir=d, ckpt_every=4)
    metrics = [h for h in hist if "event" not in h]
    assert metrics[-1]["step"] == 19
    assert metrics[-1]["ckpt_fallbacks"] == 1
    state_c, _ = _run(20)
    assert state_a.step == state_c.step == 20
    for a, c in zip(_leaves(state_a), _leaves(state_c)):
        assert torch.equal(a, c)


def test_fault_plan_corrupts_nth_save(tmp_path):
    d = str(tmp_path / "ck")
    plan = tf.TrainFaultPlan().corrupt_checkpoint(2).corrupt_checkpoint(3)
    _run(16, faults=plan, ckpt_dir=d, ckpt_every=4, keep=3)
    assert sum(s.startswith("ckpt_bitflip") for s in plan.fired) == 2
    ck = Checkpointer(d)
    assert ck.latest_step() == 16
    assert not ck.verify(16) and not ck.verify(12)
    assert ck.latest_intact_step() == 8


def _rewind_plan(mod):
    # NaN at 5, 6, 7: the guard rewinds at 7 to the checkpoint at 4; the
    # replay is clean (the plan is consumed); NaN at 9, 10, 11 spends the
    # budget of one rewind
    p = mod.TrainFaultPlan()
    for s in (5, 6, 7, 9, 10, 11):
        p.nan_grads(s)
    return p


def test_rewind_then_diverged_matches_reference(tmp_path):
    jcfg = tiny_cfg()
    src = SyntheticLM(jcfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    gkw = dict(warmup_steps=3, max_consecutive=3, max_rewinds=1)
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    logs = {"jax": [], "port": []}
    errs = {}
    jl = jloop.TrainLoopConfig(
        total_steps=16, log_every=2, straggler_factor=1e9,
        ckpt_dir=str(tmp_path / "j"), ckpt_every=4,
        guard=jloop.GuardConfig(**gkw))
    tl = tloop.TrainLoopConfig(
        total_steps=16, log_every=2, straggler_factor=1e9,
        ckpt_dir=str(tmp_path / "t"), ckpt_every=4,
        guard=tguard.GuardConfig(**gkw))
    jplan, tplan = _rewind_plan(jfaults), _rewind_plan(tf)
    with pytest.raises(jfaults.TrainingDivergedError) as je:
        jloop.train(jcfg, _opt(jadam), src, jl, state=js, faults=jplan,
                    log_fn=logs["jax"].append)
    with pytest.raises(tf.TrainingDivergedError) as te:
        tloop.train(port_cfg(jcfg), _opt(tadam), src, tl, state=ts,
                    faults=tplan, log_fn=logs["port"].append)
    errs = {k: (e.value.step, e.value.consecutive, e.value.rewinds)
            for k, e in (("jax", je), ("port", te))}
    assert errs["port"] == errs["jax"] == (11, 3, 1)
    assert tplan.fired == jplan.fired
    events = {k: [m for m in v if "event" in m] for k, v in logs.items()}
    assert events["port"] == events["jax"]
    assert [e["event"] for e in events["port"]] == ["rewind"]
    assert (events["port"][0]["step"], events["port"][0]["to_step"]) == (7, 4)
    steps = {k: [m for m in v if "event" not in m] for k, v in logs.items()}
    assert [m["step"] for m in steps["port"]] == \
        [m["step"] for m in steps["jax"]]
    for t, j in zip(steps["port"], steps["jax"]):
        for k in tloop.COUNTERS + ("anomaly",):
            assert t[k] == j[k], (t["step"], k)
    last = steps["port"][-1]
    assert (last["rewinds"], last["steps_replayed"]) == (1, 3)
    assert Checkpointer(str(tmp_path / "t")).steps() == \
        sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path / "j"))
