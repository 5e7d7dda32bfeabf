"""Knowledge distillation under ``dist=`` on the CPU: gloo ranks against
the reference's single device.

Two scenarios, each a process group started once
(``_torch_dist_rank.py``, ``kd_scenario``): a (data 1, model 2) mesh and
a (data 2, model 2) one, on ``test_torch_dist_train``'s model (BLaST
refreshes at steps 0 and 2). The teacher is a dense model of the same
config from another seed (the port's init, handed to the reference), so
the KL term is far from zero; the KD weight is 0.5 (the paper's
compression setting, ``benchmarks/bench_finetune.py``). Held on every
rank, at ``test_torch_dist_train``'s bars (loss and gradient norm to rel
1e-5, params to 5e-5, masks bitwise), against the reference's
``make_train_step`` with ``teacher_params_static`` or with the batch's
``teacher_logits``:

  * the in-step teacher on the rank's teacher shard, with ``sp`` off and
    on (the teacher's forward sequence-parallel too), over one and two
    microbatches;
  * the batches' precomputed whole-vocabulary teacher logits, narrowed to
    the rank's slice;
  * ``train_loop.train`` given the whole teacher, which it shards once;
  * the deferred step with KD and ``sp`` (uncompressed to the same bars;
    int8: each leaf's compressed mean within half a quantization step,
    each update the reference's refresh and AdamW update on that mean);
  * ``distill_loss`` at temperature 2 on vocab- and batch-sharded logits:
    the sum of the ranks' losses and each rank's slice of the gradient
    against the reference's ``value_and_grad``;
  * the planted fault: with each log-softmax's logsumexp taken over the
    rank's vocab slice only, the loss and the step miss the bars.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from repro.core import distill as jdistill  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_torch_dist_train import (LR, PARAM_ATOL, RTOL,  # noqa: E402
                                   _check_run, _initial_states, _jcfg,
                                   _opts)
from test_torch_transformer import port_cfg  # noqa: E402

STEPS, BETA = 2, 0.5
SCENARIOS = {"m2": (1, 2), "d2m2": (2, 2)}


def _as_j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ref(jcfg, js, src, teacher, batches=None, microbatches=1):
    """The reference's KD steps from ``js``: the in-step teacher, or
    (with ``batches``' logits) the batch's 'teacher_logits'."""
    jopt, _ = _opts()
    kw = dict(kd_beta=BETA, teacher_cfg=jcfg, microbatches=microbatches)
    if batches is None:
        kw["teacher_params_static"] = teacher
    step = jax.jit(jts.make_train_step(jcfg, jopt, **kw))
    out = []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in src.batch(i).items()}
        if batches is not None:
            b["teacher_logits"] = jnp.asarray(batches[i])
        js, m = step(js, b)
        out.append(dict(metrics={k: float(v) for k, v in m.items()},
                        **jax.device_get({"params": js.params,
                                          "masks": dict(js.masks)})))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both scenarios, the reference beside the first."""
    from repro_torch.models import registry
    jcfg = _jcfg()
    _, topt = _opts()
    src = SyntheticLM(jcfg.vocab_size, 32, 8, seed=1)
    js, state0 = _initial_states(jcfg)
    teacher = interop.to_numpy(registry.init_params(port_cfg(jcfg), 1,
                                                    device="cpu"))
    tj = _as_j(teacher)
    logits = [np.asarray(jreg.forward(jcfg, tj, jnp.asarray(
        src.batch(i)["tokens"]))[0]) for i in range(STEPS)]
    rng = np.random.default_rng(5)
    kl = (rng.standard_normal((4, 6, jcfg.vocab_size)).astype(np.float32)
          * 3, rng.standard_normal((4, 6, jcfg.vocab_size)
                                   ).astype(np.float32) * 3,
          rng.integers(0, jcfg.vocab_size, (4, 6)).astype(np.int32))
    spec = dict(cfg=port_cfg(jcfg), opt=topt, source=src, state=state0,
                teacher=teacher, teacher_logits=logits, steps=STEPS,
                beta=BETA, kl=kl)
    started = {}
    for name, shape in SCENARIOS.items():
        d = str(tmp_path_factory.mktemp(name))
        started[name] = (d, ranks.start(d, shape[0] * shape[1],
                                        train=dict(spec, mesh=shape),
                                        scenario="kd"))
        if len(started) == 1:
            def loss(s):
                return jdistill.distill_loss(
                    s, jnp.asarray(kl[2]), jnp.asarray(kl[1]), alpha=1.0,
                    beta=BETA, temperature=2.0)
            lv, gv = jax.value_and_grad(loss)(jnp.asarray(kl[0]))
            ref = {"kd": _ref(jcfg, js, src, tj),
                   "pre": _ref(jcfg, js, src, tj, batches=logits),
                   "mb": _ref(jcfg, js, src, tj, microbatches=2),
                   "kl": (float(lv), np.asarray(gv))}
    out = {"ref": ref, "state0": state0}
    for name, (d, procs) in started.items():
        out[name] = ranks.collect(d, procs)
    return out


def test_teacher_moves_the_loss(runs):
    """The KD term is far from zero: the reference's KD loss exceeds its
    plain cross-entropy step's by a hundred times the loss bar."""
    jcfg = _jcfg()
    jopt, _ = _opts()
    js, _ = _initial_states(jcfg)
    src = SyntheticLM(jcfg.vocab_size, 32, 8, seed=1)
    b = {k: jnp.asarray(v) for k, v in src.batch(0).items()}
    _, m = jax.jit(jts.make_train_step(jcfg, jopt))(js, b)
    kd = runs["ref"]["kd"][0]["metrics"]["loss"]
    assert kd - float(m["loss"]) > 100 * RTOL * kd


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("run,ref", [("off", "kd"), ("sp", "kd"),
                                     ("pre", "pre"), ("mb", "mb")])
def test_kd_steps_match_reference(runs, scenario, run, ref):
    """The in-step teacher (sp off and on, one and two microbatches) and
    the precomputed logits: two steps, the first a refresh."""
    for rank in runs[scenario]:
        assert len(rank[run]) == STEPS
        for got, want in zip(rank[run], runs["ref"][ref]):
            _check_run(got, want)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_kd_under_sp_reduce_scatters(runs, scenario):
    """The student's and the teacher's forwards run sequence-parallel
    (reduce-scatters in the step); with sp off none."""
    for rank in runs[scenario]:
        for got in rank["sp"] + rank["pre"]:
            assert got["collectives"]["reduce_scatter"] > 0
        for got in rank["off"]:
            assert "reduce_scatter" not in got["collectives"]
        for got in rank["deferred_c"]:
            assert got["collectives"]["reduce_scatter"] > 0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_train_loop_shards_a_whole_teacher(runs, scenario):
    for rank in runs[scenario]:
        assert rank["loop"] == pytest.approx(
            [w["metrics"]["loss"] for w in runs["ref"]["kd"]], rel=RTOL)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deferred_kd_matches_reference(runs, scenario):
    """The deferred step, uncompressed, over two microbatches of the
    rank's rows, with KD and sp: loss, params and masks to the bars."""
    for rank in runs[scenario]:
        for got, want in zip(rank["deferred"], runs["ref"]["kd"]):
            assert got["metrics"]["loss"] == pytest.approx(
                want["metrics"]["loss"], rel=RTOL)
            for a, b in zip(tadamw.tree_leaves(got["params"]),
                            tadamw.tree_leaves(want["params"])):
                np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
            for path, mk in want["masks"].items():
                np.testing.assert_array_equal(got["masks"][path], mk)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deferred_kd_compressed_within_int8_bound(runs, scenario):
    """Two int8 deferred KD steps: each leaf's compressed mean within half
    a shared quantization step of the f32 mean, the first loss the
    reference's, and each update the reference's refresh and AdamW
    update on the compressed mean, every leaf moved."""
    jcfg = _jcfg()
    jopt, _ = _opts()
    flags = jreg.dense_layer_flags(jcfg)

    @jax.jit
    def update(params, masks, moments, tg, step):
        masks, params, _ = jsm.maybe_refresh(jcfg.blast, params, tg, masks,
                                             step, flags)
        params, mv, _ = jadamw.update(
            jopt, jsm.mask_grads(masks, tg, jcfg.blast),
            jadamw.mask_moments(moments, masks, jcfg.blast), params, step)
        return params, mv, masks

    for rank in runs[scenario]:
        for err, bound in rank["compress_err"]:
            assert err <= bound * (1 + 1e-5), (err, bound)
        assert rank["deferred_c"][0]["metrics"]["loss"] == pytest.approx(
            runs["ref"]["kd"][0]["metrics"]["loss"], rel=RTOL)
        for got in rank["deferred_c"]:
            was = got["before"]
            want, mv, masks = jax.device_get(update(
                _as_j(was["params"]), _as_j(was["masks"]),
                {k: _as_j(was[k]) for k in ("m", "v")}, _as_j(got["comp"]),
                jnp.int32(was["step"])))
            for path, mk in masks.items():
                np.testing.assert_array_equal(got["masks"][path], mk)
            for k in ("m", "v"):
                for a, b in zip(tadamw.tree_leaves(got[k]),
                                tadamw.tree_leaves(mv[k])):
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=RTOL * np.abs(b).max())
            for a, b, p0 in zip(tadamw.tree_leaves(got["params"]),
                                tadamw.tree_leaves(want),
                                tadamw.tree_leaves(was["params"])):
                np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
                assert np.abs(a - p0).max() > LR / 2


def _kl_slices(rank, scenario, got_key):
    """(sum of the data ranks' losses, this rank's gradient slice and
    where it lies in the whole (rows, vocab))."""
    d, tp = SCENARIOS[scenario]
    loss, grad = rank[got_key]
    rows, v = 4 // d, 64 // tp
    r0, v0 = rank["data_rank"] * rows, rank["model_rank"] * v
    return loss, grad, (slice(r0, r0 + rows), slice(None), slice(v0, v0 + v))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_vocab_parallel_kl_at_temperature_two(runs, scenario):
    """``distill_loss`` (alpha 1, beta 0.5, T = 2) on sharded logits: the
    data ranks' losses sum to the reference's, and each rank's gradient
    is its slice of the reference's, to rel 1e-5."""
    want_loss, want_grad = runs["ref"]["kl"]
    by_data = {}
    for rank in runs[scenario]:
        loss, grad, at = _kl_slices(rank, scenario, "kl")
        by_data[rank["data_rank"]] = loss
        np.testing.assert_allclose(grad, want_grad[at], rtol=RTOL,
                                   atol=RTOL * np.abs(want_grad).max())
    assert sum(by_data.values()) == pytest.approx(want_loss, rel=RTOL)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_planted_local_logsumexp_fails(runs, scenario):
    """With each log-softmax normalised over the rank's vocab slice only,
    the KL's loss misses the reference's by far, and so does the KD
    step's."""
    want_loss, _ = runs["ref"]["kl"]
    by_data = {}
    for rank in runs[scenario]:
        loss, _, _ = _kl_slices(rank, scenario, "kl_planted")
        by_data[rank["data_rank"]] = loss
        got = rank["planted"][0]
        want = runs["ref"]["kd"][0]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) \
            > 100 * RTOL * want["metrics"]["loss"]
        with pytest.raises(AssertionError):
            _check_run(got, want)
    assert abs(sum(by_data.values()) - want_loss) > 100 * RTOL * want_loss


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_ranks_agree_bitwise(runs, scenario):
    first = runs[scenario][0]
    for rank in runs[scenario][1:]:
        for key in ("sp", "pre", "deferred"):
            for a, b in zip(rank[key], first[key]):
                assert a["metrics"] == b["metrics"]
                for x, y in zip(tadamw.tree_leaves(a["params"]),
                                tadamw.tree_leaves(b["params"])):
                    np.testing.assert_array_equal(x, y)


def test_one_device_kl_unchanged():
    """Without ``dist`` the KL is the reference's formula: mean over
    tokens of sum p_t (log p_t - log p_s), times T^2, at T = 1 and 2."""
    from repro_torch.core import distill
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((3, 5, 16)).astype(np.float32)
            for _ in range(2))
    for temp in (1.0, 2.0):
        got = float(distill.kl_to_teacher(torch.as_tensor(s),
                                          torch.as_tensor(t), temp))
        want = float(jdistill.kl_to_teacher(jnp.asarray(s), jnp.asarray(t),
                                            temp))
        assert got == pytest.approx(want, rel=1e-6)
