"""Sequence parallelism (``DistContext.sp``, on by default as in the
reference) on the CPU: gloo ranks against the reference's single device.

Two scenarios, each a process group started once
(``_torch_dist_rank.py``, ``sp_scenario``): a (data 1, model 2) mesh
and a (data 2, model 2) one. The model is ``test_torch_dist_train``'s
(4 query over 2 kv heads, d_model 64, d_ff 128, BLaST refreshes at steps
0 and 2) with ``remat`` on, so every layer's collectives run again in
the backward. Held on every rank, at that file's bars (loss and gradient
norm to rel 1e-5, params to 5e-5, masks bitwise):

  * the pairs ``gather_from_seq``, ``reduce_scatter_to_seq`` and
    ``scatter_to_seq``: forward values and gradients;
  * three sharded steps with ``sp`` on, whose residual stream inside the
    blocks is the rank's (B, S / 2, D) shard and whose steps
    reduce-scatter, and with ``sp`` off (the replicated stream, no
    reduce-scatter), against the reference's ``make_train_step``;
  * a sequence length the model axis does not divide (31): the stream
    stays whole, nothing reduce-scatters, and the steps still match;
  * the planted fault: with the norms' partial gradients left unsummed
    (``sharding.seq_partial_flags`` all False) the gradient norm misses
    the bar;
  * ``serving/step.py::make_prefill_step`` on packed params (the kernels'
    plain twins on the CPU) under ``sp``: the gathered last-token logits
    against the reference's one-device ``make_prefill_step`` to rel 1e-5;
  * ``launch.train --mesh single`` on the mesh (the production mesh's
    constructor swapped for this one): the context it builds has ``sp``
    on, its stream is split, and its losses equal the one-device
    launcher's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from repro.serving import step as jstep  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_torch_dist_serving import (_numpy_tree, _packed,  # noqa: E402
                                     _reference_tree)
from test_torch_dist_train import (PARAM_ATOL, RTOL,  # noqa: E402
                                   _check_run,
                                   _initial_states, _jcfg, _opts)
from test_torch_transformer import port_cfg  # noqa: E402

STEPS, SEQ, ODD = 3, 32, 31
SCENARIOS = {"m2": (1, 2), "d2m2": (2, 2)}
LAUNCH = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "16"]


def _cfg():
    return dataclasses.replace(_jcfg(), remat=True)


def _ref_steps(jcfg, js, src, n):
    jopt, _ = _opts()
    step = jax.jit(jts.make_train_step(jcfg, jopt))
    out = []
    for i in range(n):
        b = {k: jnp.asarray(v) for k, v in src.batch(i).items()}
        js, m = step(js, b)
        out.append(dict(metrics={k: float(v) for k, v in m.items()},
                        **jax.device_get({"params": js.params,
                                          "masks": dict(js.masks)})))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both scenarios, the reference beside the first."""
    jcfg = _cfg()
    _, topt = _opts()
    src = SyntheticLM(jcfg.vocab_size, SEQ, 8, seed=1)
    odd = SyntheticLM(jcfg.vocab_size, ODD, 8, seed=2)
    js, state0 = _initial_states(jcfg)
    pjcfg = _jcfg()
    tree = _numpy_tree(_packed(port_cfg(pjcfg), 0.8))
    prompts = np.random.default_rng(3).integers(
        1, pjcfg.vocab_size, (4, 16)).astype(np.int32)
    spec = dict(cfg=port_cfg(jcfg), opt=topt, source=src, odd=odd,
                state=state0, steps=STEPS, packed_cfg=port_cfg(pjcfg),
                packed=tree, prompts=prompts, launch=LAUNCH)
    started = {}
    for name, shape in SCENARIOS.items():
        d = str(tmp_path_factory.mktemp(name))
        started[name] = (d, ranks.start(d, shape[0] * shape[1],
                                        train=dict(spec, mesh=shape),
                                        scenario="sp"))
        if len(started) == 1:
            ref = {"sp": _ref_steps(jcfg, js, src, STEPS),
                   "odd": _ref_steps(jcfg, js, odd, 2),
                   "prefill": np.asarray(jstep.make_prefill_step(pjcfg)(
                       _reference_tree(tree), jnp.asarray(prompts)))}
            from repro_torch.launch import train as ltrain
            _, hist = ltrain.main(LAUNCH)
            ref["launch"] = [h["loss"] for h in hist if "loss" in h]
    out = {"ref": ref, "state0": state0}
    for name, (d, procs) in started.items():
        out[name] = ranks.collect(d, procs)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pairs_forward_and_backward(runs, scenario):
    """gather_from_seq: the shards in rank order, the gradient summed
    over the ranks; reduce_scatter_to_seq: the rank's slice of the sum,
    the gradient all-gathered; scatter_to_seq: the rank's slice, the
    gradient all-gathered (zero nowhere)."""
    tp = SCENARIOS[scenario][1]
    base = lambda n: np.arange(n * 2.0).reshape(1, n, 2)  # noqa: E731
    for rank in runs[scenario]:
        r, pairs = rank["rank"], rank["pairs"]
        y, g = pairs["gather_from_seq"]
        np.testing.assert_array_equal(
            y, np.concatenate([base(3) + 100 * q for q in range(tp)], 1))
        w = np.arange(6 * tp, dtype=np.float64).reshape(1, 3 * tp, 2)
        want = sum(q + 1 for q in range(tp)) * w[:, 3 * r:3 * r + 3]
        np.testing.assert_array_equal(g, want)
        y, g = pairs["reduce_scatter_to_seq"]
        whole = sum(base(3 * tp) + 100 * q for q in range(tp))
        np.testing.assert_array_equal(y, whole[:, 3 * r:3 * r + 3])
        part = np.arange(6.0).reshape(1, 3, 2)
        np.testing.assert_array_equal(
            g, np.concatenate([part * (q + 1) for q in range(tp)], 1))
        y, g = pairs["scatter_to_seq"]
        np.testing.assert_array_equal(
            y, (base(3 * tp) + 100 * r)[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(
            g, np.concatenate([part * (q + 1) for q in range(tp)], 1))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sp_is_the_default_and_splits_the_stream(runs, scenario):
    tp = SCENARIOS[scenario][1]
    d = SCENARIOS[scenario][0]
    for rank in runs[scenario]:
        assert rank["default_sp"] is True
        for run in rank["sp"]:
            assert run["stream"] == [(8 // d, SEQ // tp, 64)]
            assert run["collectives"].get("reduce_scatter", 0) > 0
        for run in rank["sp_off"]:
            assert run["stream"] == [(8 // d, SEQ, 64)]
            assert "reduce_scatter" not in run["collectives"]
    assert DistContext().sp is True


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("layout", ["sp", "sp_off"])
def test_steps_match_reference(runs, scenario, layout):
    """Three steps (refreshes at 0 and 2) with the stream split and
    whole, against the reference's single device."""
    for rank in runs[scenario]:
        for got, want in zip(rank[layout], runs["ref"]["sp"]):
            _check_run(got, want)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_undivided_sequence_stays_replicated(runs, scenario):
    """S = 31 over a model axis of 2: the stream stays whole, nothing
    reduce-scatters, and the two steps match the reference."""
    d = SCENARIOS[scenario][0]
    for rank in runs[scenario]:
        for got, want in zip(rank["odd"], runs["ref"]["odd"]):
            assert got["stream"] == [(8 // d, ODD, 64)]
            assert "reduce_scatter" not in got["collectives"]
            _check_run(got, want)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_planted_unsummed_norm_gradients_fail(runs, scenario):
    """With the norms' partial gradients left unsummed the loss is still
    right (the forward does not change) but the gradient norm misses the
    bar, and so do the norm scales after the update."""
    want = runs["ref"]["sp"][0]
    for rank in runs[scenario]:
        got = rank["planted"][0]
        assert got["metrics"]["loss"] == pytest.approx(
            want["metrics"]["loss"], rel=RTOL)
        err = abs(got["metrics"]["grad_norm"] - want["metrics"]["grad_norm"])
        assert err > RTOL * want["metrics"]["grad_norm"]
        scale = max(np.abs(got["params"][k] - want["params"][k]).max()
                    for k in ("ln_f_scale",))
        lay = max(np.abs(got["params"]["layers"][k]
                         - want["params"]["layers"][k]).max()
                  for k in ("ln_attn_scale", "ln_mlp_scale"))
        assert max(scale, lay) > PARAM_ATOL
        with pytest.raises(AssertionError):
            _check_run(got, want)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_ranks_agree_bitwise(runs, scenario):
    first = runs[scenario][0]
    for rank in runs[scenario][1:]:
        for a, b in zip(rank["sp"] + rank["odd"], first["sp"] + first["odd"]):
            assert a["metrics"] == b["metrics"]
            for x, y in zip(tadamw.tree_leaves(a["params"]),
                            tadamw.tree_leaves(b["params"])):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_packed_prefill_under_sp(runs, scenario):
    """``make_prefill_step`` on packed params, sequence-parallel: every
    rank returns the whole last-token rows, equal to the reference's
    single device to rel 1e-5; the stream is split (its S over the model
    axis, and its rows over the data axis: a data group runs its own)
    and reduce-scatters ran."""
    want = runs["ref"]["prefill"]
    d, tp = SCENARIOS[scenario]
    for rank in runs[scenario]:
        p = rank["prefill"]
        assert p["logits"].shape == want.shape
        np.testing.assert_allclose(p["logits"], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
        assert p["stream"] == [(4 // d, 16 // tp, 64)]
        assert p["collectives"]["reduce_scatter"] > 0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_launcher_mesh_takes_the_sp_default(runs, scenario):
    """``launch.train --mesh single`` builds the reference's
    ``DistContext(mesh=mesh)``: sp on, the stream split, reduce-scatters
    issued, and the one-device launcher's losses."""
    tp = SCENARIOS[scenario][1]
    d = SCENARIOS[scenario][0]
    for rank in runs[scenario]:
        la = rank["launch"]
        assert la["sp"] is True
        assert la["stream"] == [(4 // d, 16 // tp, 64)]
        assert la["collectives"]["reduce_scatter"] > 0
        assert la["losses"] == pytest.approx(runs["ref"]["launch"],
                                             rel=RTOL)


def test_seq_split_mirrors_constrain_seq():
    """A 3-D activation, a model axis over 1 and S divisible by it; sp
    off, a model axis of 1, a 2-D or 4-D shape or an S the axis does not
    divide leave the stream whole."""
    m2 = DistContext(Mesh(("data", "model"), (2, 2), 0))
    assert m2.seq_split((4, 8, 16))
    assert m2.seq_split(torch.zeros(1, 2, 3))
    for shape in ((4, 7, 16), (4, 8), (1, 4, 8, 16)):
        assert not m2.seq_split(shape)
    assert not DistContext(Mesh(("data", "model"), (2, 2), 0),
                           sp=False).seq_split((4, 8, 16))
    assert not DistContext(Mesh(("data", "model"), (4, 1), 0)
                           ).seq_split((4, 8, 16))
    assert not DistContext().seq_split((4, 8, 16))


def test_seq_partial_leaves_are_the_residual_norms():
    """The replicated leaves that act on the stream's shard: the norms'
    scales (and a layernorm's biases), nothing else."""
    from repro_torch.configs import get_config
    for cfg, want in (
            (port_cfg(_jcfg()), {"layers/ln_attn_scale",
                                 "layers/ln_mlp_scale", "ln_f_scale"}),
            (get_config("stablelm-3b", smoke=True),
             {"layers/ln_attn_scale", "layers/ln_attn_bias",
              "layers/ln_mlp_scale", "layers/ln_mlp_bias", "ln_f_scale",
              "ln_f_bias"})):
        flags = sharding.seq_partial_flags(cfg)

        def walk(t, pre=""):
            if isinstance(t, dict):
                return {x for k, v in t.items()
                        for x in walk(v, f"{pre}{k}/")}
            return {pre[:-1]} if t else set()
        assert walk(flags) == want


def test_teacher_shards_like_the_student():
    """``shard_teacher`` takes ``train_specs``' layout: a whole teacher
    cut with it equals the student's params cut with the state's."""
    from repro_torch.models import registry
    cfg = port_cfg(_jcfg())
    mesh = Mesh(("data", "model"), (1, 2), 1)
    whole = registry.init_params(cfg, 1, device="cpu")
    got = sharding.shard_teacher(cfg, whole, mesh)
    want = sharding.shard_tree(whole,
                               sharding.state_shardings(cfg, mesh).params)
    for a, b in zip(tadamw.tree_leaves(got), tadamw.tree_leaves(want)):
        assert torch.equal(a, b)
    assert got["layers"]["mlp"]["w_gate"].shape[-1] == cfg.d_ff // 2
