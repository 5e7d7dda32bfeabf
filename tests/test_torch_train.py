"""The port's trainer against the reference: prune-and-grow masks, the
STE, mask-tree helpers, the masked training forward and its gradients,
the train step step by step from one carried-over reference state, the
skip-update path, and the train loop's history and guard counters.

Weights and states cross through ``interop``; the port does not imitate
JAX's PRNG. Integer outputs (masks, keep counts, counters) are bitwise.
f32 values: on ``tiny_cfg`` within about 1e-5 of their magnitude (gradients, which
sum over every token and layer, 5e-5; the largest seen is 2.2e-5). On
``LLAMA32_1B_SMOKE`` the random weights make attention sharp (query and
key weights of std 0.5), so f32 summation-order differences already
reach about 1.5e-4 of the gradients' magnitude from identical params;
its gradient tolerance is 1e-3 of the magnitude. Over several AdamW
steps an element whose gradient is a cancellation of larger terms has a
large relative error, and Adam's normalisation turns it into up to one
learning rate of displacement, so params are held to within one
learning rate there (the learning rate is 1e-4, and the per-step loss
stays within 1e-5 relative)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import prune_grow as jpg, sparse_mlp as jsm  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import faults as jfaults  # noqa: E402
from repro.training import step as jts, train_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import prune_grow as tpg, sparse_mlp as tsm  # noqa: E402
from repro_torch.core import topk as ttk  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import guard as tguard  # noqa: E402
from repro_torch.training import step as tts, train_loop as tloop  # noqa: E402

LR = 1e-4
CFGS = {"tiny": tiny_cfg, "smoke": lambda: jpm.LLAMA32_1B_SMOKE}
GRAD_REL = {"tiny": 5e-5, "smoke": 1e-3}
PARAM_ATOL = {"tiny": 1e-6, "smoke": LR}


def port_cfg(jcfg, **kw):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["blast"] = tpg.BlastSpec(**dataclasses.asdict(jcfg.blast))
    d.update(kw)
    return ModelConfig(**d)


def _opt(**kw):
    j = jadam.AdamWConfig(peak_lr=LR, warmup_steps=1, total_steps=20, **kw)
    return j, tadam.AdamWConfig(**dataclasses.asdict(j))


def _assert_tree_close(got, want, rel=0.0, atol=0.0):
    for g, w in zip(tadam.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rel,
            atol=atol + rel * float(np.abs(w).max() + 1e-30))


def _masks_equal(tmasks, jmasks):
    assert set(tmasks) == set(jmasks)
    for p in jmasks:
        np.testing.assert_array_equal(tmasks[p].numpy(), np.asarray(jmasks[p]))


# ------------------------------------------------------------ masks
@pytest.mark.parametrize("selection", ["balanced", "global"])
@pytest.mark.parametrize("step", [0, 3, 7, 20])
def test_generate_mask_and_refresh_bitwise(selection, step):
    rng = np.random.default_rng(step)
    w = rng.standard_normal((3, 64, 96)).astype(np.float32)
    g = rng.standard_normal((3, 64, 96)).astype(np.float32)
    old = rng.random((3, 4, 6)) < 0.5
    jspec = jpg.BlastSpec(b_in=16, b_out=16, s_max=0.75, total_steps=20,
                          selection=selection)
    tspec = tpg.BlastSpec(**dataclasses.asdict(jspec))
    f = jax.jit(lambda w_, g_, o_, s_: jpg.refresh_mask_and_weight(
        jspec, w_, g_, o_, s_))
    jm, jw, jg = f(jnp.asarray(w), jnp.asarray(g), jnp.asarray(old),
                   jnp.int32(step))
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    tm = tpg.generate_mask(tspec, tw, tg, step)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    rm, rw, rg = tpg.refresh_mask_and_weight(tspec, tw, tg,
                                             torch.from_numpy(old), step)
    np.testing.assert_array_equal(rm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(rg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(rw.numpy(), np.asarray(jw))


def test_refresh_masks_tree_with_dense_flags_bitwise():
    jcfg = tiny_cfg(num_layers=3)
    tcfg = port_cfg(jcfg)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        params)
    jflags = jreg.dense_layer_flags(jcfg)
    masks = jreg.init_masks(jcfg, params)
    jm, jp, jg = jax.jit(lambda p, g, m, s: jsm.refresh_masks(
        jcfg.blast, p, g, m, s, jflags))(params, grads, masks, jnp.int32(9))
    tflags = treg.dense_layer_flags(tcfg)
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    tp = interop.to_torch(jax.device_get(params), device="cpu")
    tmasks = treg.init_masks(tcfg, tp)
    _masks_equal(tmasks, masks)
    tm, tparams, tg = tsm.refresh_masks(
        tcfg.blast, tp, interop.to_torch(jax.device_get(grads), device="cpu"),
        tmasks, 9, tflags)
    _masks_equal(tm, jm)
    _masks_equal(tg, jg)
    _assert_tree_close(tparams, jp)
    assert float(tsm.tree_sparsity(tm)) == pytest.approx(
        float(jsm.tree_sparsity(jm)), abs=1e-6)
    for path, m in tm.items():       # the dense_last layer keeps all
        assert bool(m[-1].all())
    # no refresh off the cadence (step_size 5)
    same, p2, grown = tsm.maybe_refresh(tcfg.blast, tp, tp, tmasks, 9, tflags)
    assert same is tmasks and p2 is tp
    assert not any(bool(x.any()) for x in grown.values())


def test_ste_forward_masks_backward_dense_and_mask_grads():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    mask = rng.random((4, 3)) < 0.5
    c = rng.standard_normal((32, 48)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda w_: jsm.apply_mask_ste(
        w_, jnp.asarray(mask), 8, 16), jnp.asarray(w))
    (jgw,) = jvjp(jnp.asarray(c))
    tw = torch.from_numpy(w).requires_grad_()
    ty = tsm.apply_mask_ste(tw, torch.from_numpy(mask), 8, 16)
    (tgw,) = torch.autograd.grad((ty * torch.from_numpy(c)).sum(), (tw,))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tgw.numpy(), np.asarray(jgw))
    np.testing.assert_array_equal(tgw.numpy(), c)       # dense gradient
    spec = jpg.BlastSpec(b_in=8, b_out=16)
    jmg = jsm.mask_grads({"a/w_gate": jnp.asarray(mask)},
                         {"a": {"w_gate": jnp.asarray(c)}}, spec)
    tmg = tsm.mask_grads({"a/w_gate": torch.from_numpy(mask)},
                         {"a": {"w_gate": torch.from_numpy(c)}},
                         tpg.BlastSpec(**dataclasses.asdict(spec)))
    np.testing.assert_array_equal(tmg["a"]["w_gate"].numpy(),
                                  np.asarray(jmg["a"]["w_gate"]))


def test_registry_counts_and_flags():
    for jcfg in (tiny_cfg(), jpm.LLAMA32_1B_SMOKE, jpm.LLAMA32_1B,
                 jpm.GPT2_SMALL):
        tcfg = port_cfg(jcfg)
        assert treg.count_params(tcfg) == jreg.count_params(jcfg)
        np.testing.assert_array_equal(treg.dense_layer_flags(tcfg).numpy(),
                                      np.asarray(jreg.dense_layer_flags(jcfg)))


# ---------------------------------------------------- forward + grads
def _random_masks(jcfg, params, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.random(np.asarray(m).shape) < 0.6
            for p, m in jreg.init_masks(jcfg, params).items()}


@pytest.mark.parametrize("name", ["tiny", "smoke"])
def test_forward_with_masks_and_its_gradients(name):
    jcfg = CFGS[name]()
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    masks = _random_masks(jcfg, params, 1)
    batch = SyntheticLM(jcfg.vocab_size, 16, 3, seed=2).batch(0)

    def jloss(p):
        return jts.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                     for k, v in masks.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()})
    (jl, (jlogits, _)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmasks = {k: torch.from_numpy(v) for k, v in masks.items()}
    out = {}
    for remat in (False, True):
        tcfg = port_cfg(jcfg, remat=remat)
        leaves = tts._leaf_params(
            interop.to_torch(jax.device_get(params), device="cpu"))
        tl, (tlogits, _) = tts.loss_fn(tcfg, leaves, tmasks, tb)
        tg = torch.autograd.grad(tl, tadam.tree_leaves(leaves))
        out[remat] = (tl.detach(), tlogits.detach(), tg)
    tl, tlogits, tg = out[False]
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=GRAD_REL[name] * float(
                                   np.abs(np.asarray(jlogits)).max()))
    _assert_tree_close(dict(enumerate(tg)),
                       dict(enumerate(jax.tree_util.tree_leaves(jg))),
                       rel=GRAD_REL[name])
    # remat changes memory, not numbers
    assert torch.equal(out[True][1], tlogits)
    for a, b in zip(out[True][2], tg):
        assert torch.equal(a, b)


# ------------------------------------------------------- train steps
@pytest.fixture(scope="module")
def six_steps():
    """Six steps of both trainers from one reference state carried over,
    per config: (losses, masks at every step, final params) each side."""
    runs = {}
    for name, make in CFGS.items():
        jcfg = make()
        jopt, topt = _opt()
        js = jts.init_state(jcfg, jax.random.PRNGKey(0))
        ts = interop.train_state(jax.device_get(js), device="cpu")
        jstep = jax.jit(jts.make_train_step(jcfg, jopt))
        tstep = tts.make_train_step(port_cfg(jcfg), topt)
        src = SyntheticLM(jcfg.vocab_size, 16, 4, seed=1)
        rec = {"j": [], "t": []}
        for i in range(6):
            b = src.batch(i)
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
            rec["j"].append((jm, jax.device_get(js.masks)))
            rec["t"].append((tm, ts.masks))
        runs[name] = (jcfg, js, ts, rec)
    return runs


@pytest.mark.parametrize("name", ["tiny", "smoke"])
def test_six_train_steps_match_reference(six_steps, name):
    jcfg, js, ts, rec = six_steps[name]
    for i, ((jm, jmask), (tm, tmask)) in enumerate(zip(rec["j"], rec["t"])):
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5), i
        assert tm["lr"] == float(jm["lr"])
        assert tm["anomaly"] == int(jm["anomaly"]) == 0
        assert float(tm["sparsity"]) == pytest.approx(float(jm["sparsity"]),
                                                      abs=1e-6)
        _masks_equal(tmask, jmask)
    # refreshes at steps 0 and 5 (step_size 5): step 5 prunes
    assert float(rec["t"][5][0]["sparsity"]) > 0.0
    assert ts.step == int(js.step) == 6
    _assert_tree_close(ts.params, js.params, rel=1e-5,
                       atol=PARAM_ATOL[name])
    # pruned blocks are exactly zero in the params and both moments
    for path, mask in ts.masks.items():
        bi, bo = tsm.block_dims_for(ts_spec(jcfg), path)
        pruned = ~ttk.expand_mask(mask, bi, bo)
        for tree in (ts.params, ts.opt_state["m"], ts.opt_state["v"]):
            assert not bool(tsm.get_path(tree, path)[pruned].any())


def ts_spec(jcfg):
    return tpg.BlastSpec(**dataclasses.asdict(jcfg.blast))


@pytest.fixture(scope="module")
def two_steps_in():
    """Both trainers two steps into a tiny run (moments and params have
    moved), with the compiled reference step."""
    jcfg = tiny_cfg()
    jopt, topt = _opt()
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    tstep = tts.make_train_step(port_cfg(jcfg), topt)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt))
    src = SyntheticLM(jcfg.vocab_size, 16, 4, seed=1)
    for i in range(2):
        b = src.batch(i)
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, _ = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    return js, ts, jstep, tstep, src.batch(2)


@pytest.mark.parametrize("kind", ["nan", "inf", "force_skip"])
def test_skipped_step_leaves_state_bitwise_unchanged(two_steps_in, kind):
    js, ts, jstep, tstep, b = two_steps_in
    scal = {"grad_poison": {"nan": np.nan, "inf": np.inf}.get(kind, 0.0),
            "loss_poison": 0.0, "force_skip": float(kind == "force_skip")}
    state = lambda s: tadam.tree_leaves(  # noqa: E731
        {"p": s.params, "o": s.opt_state, "m": s.masks})
    before = [x.clone() for x in state(ts)]
    ts2, tm = tstep(ts, {**{k: torch.from_numpy(v) for k, v in b.items()},
                         **scal})
    js2, jm = jstep(js, {**{k: jnp.asarray(v) for k, v in b.items()},
                         **{k: jnp.float32(v) for k, v in scal.items()}})
    assert tm["anomaly"] == int(jm["anomaly"]) == 1
    assert ts2.step == int(js2.step) == 3
    for x, y in zip(state(ts2), before):
        assert torch.equal(x, y)
    assert np.isfinite(tm["loss"]) == np.isfinite(float(jm["loss"]))


def test_microbatches_and_in_step_teacher_match_reference():
    """One step with gradient accumulation over 2 microbatches and a
    dense in-step KD teacher (kd_beta 0.5)."""
    jcfg = tiny_cfg()
    jteacher = tiny_cfg(blast=dataclasses.replace(jcfg.blast, enabled=False))
    jopt, topt = _opt(weight_decay=0.0)
    tparams = jreg.init_params(jteacher, jax.random.PRNGKey(3))
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    jstep = jax.jit(jts.make_train_step(
        jcfg, jopt, kd_beta=0.5, teacher_cfg=jteacher,
        teacher_params_static=tparams, microbatches=2))
    tstep = tts.make_train_step(
        port_cfg(jcfg), topt, kd_beta=0.5, teacher_cfg=port_cfg(jteacher),
        teacher_params_static=interop.to_torch(jax.device_get(tparams),
                                               device="cpu"),
        microbatches=2)
    src = SyntheticLM(jcfg.vocab_size, 16, 4, seed=1)
    for i in range(2):
        b = src.batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                                rel=1e-5)
    _assert_tree_close(ts.params, js.params, rel=1e-5, atol=1e-6)


# -------------------------------------------------------- train loop
def _loop_runs():
    jcfg = tiny_cfg()
    jopt, topt = _opt()
    gcfg = dict(warmup_steps=3, max_consecutive=3)
    src = SyntheticLM(jcfg.vocab_size, 16, 4, seed=3)

    def plan():
        return (jfaults.TrainFaultPlan().nan_grads(2).force_skip(5)
                .loss_spike(7, 1e3).nan_grads(9).nan_grads(10, "inf")
                .nan_grads(11))
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    jl = jloop.TrainLoopConfig(total_steps=14, log_every=3,
                               straggler_factor=1e9,
                               guard=jloop.GuardConfig(**gcfg))
    tl = tloop.TrainLoopConfig(total_steps=14, log_every=3,
                               straggler_factor=1e9,
                               guard=tguard.GuardConfig(**gcfg))
    _, jh = jloop.train(jcfg, jopt, src, jl, state=js, faults=plan(),
                        log_fn=lambda m: None)
    _, th = tloop.train(port_cfg(jcfg), topt, src, tl, state=ts,
                        faults=plan(), log_fn=lambda m: None)
    return jh, th


def test_train_loop_history_and_guard_counters_match_reference():
    jh, th = _loop_runs()
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert set(t) == set(j)
        if "event" in j:
            assert t == j
            continue
        for k, v in j.items():
            if k == "sec_per_step":
                continue
            if k in ("loss", "grad_norm") and np.isfinite(v):
                assert t[k] == pytest.approx(v, rel=1e-5), k
            elif k == "sparsity":
                assert t[k] == pytest.approx(v, abs=1e-6)
            else:
                assert t[k] == v or (np.isnan(v) and np.isnan(t[k])), k
    counters = {k: th[-1][k] for k in tloop.COUNTERS}
    assert counters == {k: jh[-1][k] for k in tloop.COUNTERS}
    assert counters["skipped_steps"] == 5 and counters["spike_steps"] == 1
    assert [e["step"] for e in th if e.get("event")] == [11]


def test_train_loop_refuses_checkpointing(tmp_path):
    loop = tloop.TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        tloop.train(port_cfg(tiny_cfg()), _opt()[1], None, loop,
                    device="cpu")
