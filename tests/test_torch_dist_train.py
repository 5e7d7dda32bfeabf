"""The sharded train step on the CPU (``dist=``): gloo ranks against the
reference's single device.

Two scenarios of 4 ranks, each a process group started once
(``_torch_dist_rank.py``, ``train_scenario``): a (data 2, model 2) mesh
and a (data 1, model 4) one, where the 2 kv heads do not split and are
narrowed from replicated projections. The model is the reference's
multi-device test model, ``tiny_cfg`` with 4 query over 2 kv heads,
d_model 64 and d_ff 128, BLaST on with a refresh at steps 0 and 2 (its
schedule cut to 4 steps so the second refresh prunes a quarter of the
blocks). Both packages start from one initial state and every rank
takes the same global batches, its rows of each. The weights are the
port's seeded init (true fan-in, ``models/params.py``), handed to the
reference: from the reference's own init (attention weights 8-16x too
large) this random network is so sharp that the one-device port and the
reference already differ by 1.3e-5 to 4e-5 in the gradient norm over
these three steps (the embedding's gradient), so a 1e-5 bar would test
the init's conditioning; from the port's they agree to 3e-7.

Held against the reference's single-device ``make_train_step``, on every
rank: the sharded step's loss and gradient norm to rel 1e-5, the
gathered params to abs 5e-5 (the reference's own bar in
``test_deferred.py``) and the gathered masks bitwise after both
refreshes; the guard's skips; the deferred step (uncompressed to the
same bars; int8-compressed over two steps: each leaf's compressed mean
within half a quantization step of the f32 mean, the loss to rel 1e-5,
and each update equal, to the same bars, to the reference's refresh and
AdamW update applied to that compressed mean); a reduction whose
ranks' scales differ, where the reference's formula is off by far more
than that bound; and an elastic restart: a checkpoint written by the
sharded train loop under (data 2, model 2) resumes on a (data 1, model
2) sub-mesh and on one device with the uninterrupted run's next loss,
and its files equal a one-device save of the same state. The launcher
and the refusals run in-process.
"""
import dataclasses
import json
import os
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.core.prune_grow import BlastSpec as JBlast  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

STEPS, LR = 3, 1e-4
SCENARIOS = {"d2m2": (2, 2), "d1m4": (1, 4)}
RTOL, PARAM_ATOL = 1e-5, 5e-5


def _jcfg():
    return tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64, d_ff=128,
                    head_dim=16,
                    blast=JBlast(enabled=True, b_in=16, b_out=16,
                                 s_max=0.75, total_steps=4, step_size=2,
                                 dense_last=1))


def _opts():
    kw = dict(peak_lr=LR, total_steps=20, warmup_steps=0)
    return jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)


def _leaves(tree):
    return tadamw.tree_leaves(tree)


def _initial_states(jcfg):
    """(the reference's TrainState, the same state as numpy) from the
    port's seeded init: all-kept masks, zero moments, step 0."""
    from repro_torch.training import step as ts
    st = ts.init_state(port_cfg(jcfg), 0, "cpu")
    host = types.SimpleNamespace(
        step=np.asarray(0, np.int32), params=interop.to_numpy(st.params),
        opt_state={k: interop.to_numpy(st.opt_state[k]) for k in ("m", "v")},
        masks=interop.to_numpy(st.masks))
    js = jts.init_state(jcfg, jax.random.PRNGKey(0))
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    js = dataclasses.replace(js, params=as_j(host.params),
                             opt_state=as_j(host.opt_state),
                             masks=as_j(host.masks))
    return js, host


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the scenarios one after the other (4 rank processes at a time
    beside the test workers), the reference beside the first."""
    jcfg = _jcfg()
    jopt, topt = _opts()
    src = SyntheticLM(jcfg.vocab_size, 32, 8, seed=1)
    js, state0 = _initial_states(jcfg)
    specs = {}
    for name, shape in SCENARIOS.items():
        d = str(tmp_path_factory.mktemp(name))
        specs[name] = (d, dict(cfg=port_cfg(jcfg), opt=topt, source=src,
                               state=state0, steps=STEPS, mesh=shape,
                               ckpt_dir=os.path.join(d, "ckpt"),
                               single_dir=os.path.join(d, "single")))

    def start(name):
        d, spec = specs[name]
        return d, spec, ranks.start(d, 4, train=spec)

    first, second = SCENARIOS
    started = start(first)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt))
    ref = []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in src.batch(i).items()}
        js, m = jstep(js, b)
        ref.append(dict(metrics={k: float(v) for k, v in m.items()},
                        **jax.device_get({"params": js.params,
                                          "masks": dict(js.masks)})))
    out = {"ref": ref, "state0": state0, "src": src, "topt": topt}
    for name in (first, second):
        if name == second:
            started = start(second)
        d, spec, procs = started
        out[name] = dict(spec=spec, ranks=ranks.collect(d, procs))
    return out


def _check_run(got, want, masks=True):
    m, w = got["metrics"], want["metrics"]
    assert m["loss"] == pytest.approx(w["loss"], rel=RTOL)
    assert m["grad_norm"] == pytest.approx(w["grad_norm"], rel=RTOL)
    # the reference's jitted 1 - kept/total rounds to -3e-8 when all kept
    assert m["sparsity"] == pytest.approx(w["sparsity"], abs=1e-6)
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    if masks:
        for path, mk in want["masks"].items():
            np.testing.assert_array_equal(got["masks"][path], mk)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sharded_step_matches_reference(runs, scenario):
    """Three steps (refreshes at 0 and 2) on every rank: loss and grad
    norm to rel 1e-5, params to 5e-5, masks bitwise."""
    assert runs["ref"][2]["metrics"]["sparsity"] > 0.2   # a real refresh
    for rank in runs[scenario]["ranks"]:
        for got, want in zip(rank["sharded"], runs["ref"]):
            _check_run(got, want)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_ranks_agree_bitwise(runs, scenario):
    """Every rank reads the same metrics and gathers the same state."""
    first = runs[scenario]["ranks"][0]
    for rank in runs[scenario]["ranks"][1:]:
        for a, b in zip(rank["sharded"] + rank["deferred"],
                        first["sharded"] + first["deferred"]):
            assert a["metrics"] == b["metrics"]
            for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_guard_skips_on_every_rank(runs, scenario):
    """force_skip and a NaN grad_poison skip the update on every rank:
    the state comes back bitwise, only the step advances."""
    s0 = runs["state0"]
    for rank in runs[scenario]["ranks"]:
        for g in rank["guard"]:
            assert g["metrics"]["anomaly"] == 1, g["what"]
            assert g["step"] == 1
            for a, b in zip(_leaves(g["params"]), _leaves(s0.params)):
                np.testing.assert_array_equal(a, b)
            for path, mk in s0.masks.items():
                np.testing.assert_array_equal(g["masks"][path], mk)
        skip = rank["guard"][0]["metrics"]
        assert skip["loss"] == pytest.approx(
            runs["ref"][0]["metrics"]["loss"], rel=RTOL)
        assert np.isnan(rank["guard"][1]["metrics"]["loss"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deferred_matches_reference(runs, scenario):
    """The deferred step, uncompressed, over two microbatches: the same
    bars against the reference's one-device step (its grad_norm is the
    clipped update's, of the masked gradients, so only the loss and the
    state are held)."""
    for rank in runs[scenario]["ranks"]:
        for got, want in zip(rank["deferred"], runs["ref"]):
            assert got["metrics"]["loss"] == pytest.approx(
                want["metrics"]["loss"], rel=RTOL)
            for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
                np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
            for path, mk in want["masks"].items():
                np.testing.assert_array_equal(got["masks"][path], mk)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_deferred_compressed_within_int8_bound(runs, scenario):
    """Two int8 deferred steps, the second with the first's error
    feedback. Each leaf's compressed mean lies within half a shared
    quantization step of the f32 mean of gradient plus error feedback,
    and the first loss (taken before the update) within rel 1e-5 of the
    reference's. Each step's update is the reference's: its
    ``maybe_refresh``, ``mask_grads``, ``mask_moments`` and AdamW
    ``update`` applied to the compressed mean from the state before the
    step give the masks bitwise, the moments to 1e-5 of each leaf's
    largest entry and the params to 5e-5, while every leaf moved by over lr / 2 (so a skipped update,
    one of unreduced or sign-flipped gradients, cannot pass). The step
    carries the error feedback its reduction made."""
    jcfg = _jcfg()
    jopt, _ = _opts()
    flags = jreg.dense_layer_flags(jcfg)
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731

    @jax.jit
    def update(params, masks, moments, tg, step):
        masks, params, _ = jsm.maybe_refresh(jcfg.blast, params, tg, masks,
                                             step, flags)
        params, mv, _ = jadamw.update(
            jopt, jsm.mask_grads(masks, tg, jcfg.blast),
            jadamw.mask_moments(moments, masks, jcfg.blast), params, step)
        return params, mv, masks

    for rank in runs[scenario]["ranks"]:
        for err, bound in rank["compress_err"]:
            assert err <= bound * (1 + 1e-5), (err, bound)
        assert len(rank["deferred_c"]) == 2
        assert rank["deferred_c"][0]["metrics"]["loss"] == pytest.approx(
            runs["ref"][0]["metrics"]["loss"], rel=RTOL)
        for got in rank["deferred_c"]:
            assert got["ef_carried"]
            was = got["before"]
            want, mv, masks = jax.device_get(update(
                as_j(was["params"]), as_j(was["masks"]),
                {k: as_j(was[k]) for k in ("m", "v")}, as_j(got["comp"]),
                jnp.int32(was["step"])))
            for path, mk in masks.items():
                np.testing.assert_array_equal(got["masks"][path], mk)
            for k in ("m", "v"):
                for a, b in zip(_leaves(got[k]), _leaves(mv[k])):
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=RTOL * np.abs(b).max())
            for a, b, p0 in zip(_leaves(got["params"]), _leaves(want),
                                _leaves(was["params"])):
                np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
                assert np.abs(a - p0).max() > LR / 2


def test_unequal_scales_reference_formula_is_biased(runs):
    """Two data ranks with gradients [1.0] and [0.01] (and 1000-element
    ones a hundredfold apart): the port's mean is within half a shared
    quantization step of the true mean; the reference's formula (each
    rank's own scale, the payloads summed, times the largest scale) is
    off by far more."""
    ranks_ = runs["d2m2"]["ranks"]
    for case in range(2):
        by_data = {}
        for r in ranks_:
            g, got = r["unequal"][case]
            by_data.setdefault(tuple(g[:3]), (g, got))
        (g0, got), (g1, _) = by_data.values()
        true = (g0 + g1) / 2
        bound = max(np.abs(g0).max(), np.abs(g1).max()) / 127 / 2
        for r in ranks_:
            np.testing.assert_array_equal(r["unequal"][case][1], got)
        assert np.abs(got - true).max() <= bound * (1 + 1e-5)
        qs = [jcompress.quantize_int8(jnp.asarray(g), jnp.zeros_like(
            jnp.asarray(g))) for g in (g0, g1)]
        ref = (np.asarray(qs[0][0], np.int32) + np.asarray(qs[1][0],
                                                          np.int32)
               ).astype(np.float32) * max(float(q[1]) for q in qs) / 2
        assert np.abs(ref - true).max() > 10 * bound


def test_elastic_restart_across_meshes(runs, tmp_path):
    """The train loop under (data 2, model 2) checkpoints after two
    steps; a (data 1, model 2) sub-mesh and one device restore it and
    take step 2 with the uninterrupted run's loss; the files equal a
    one-device save of the same (gathered) state."""
    from repro_torch.checkpointing.checkpoint import Checkpointer
    from repro_torch.training import step as ts
    run = runs["d2m2"]
    ref = runs["ref"]
    r0 = run["ranks"][0]
    for got, want in zip(r0["loop_losses"], ref[:2]):
        assert got == pytest.approx(want["metrics"]["loss"], rel=RTOL)
    want = ref[2]["metrics"]["loss"]
    subs = [r["elastic"] for r in run["ranks"] if "elastic" in r]
    assert len(subs) == 2
    for e in subs:
        assert e["step"] == 2
        assert e["metrics"]["loss"] == pytest.approx(want, rel=RTOL)
    spec = run["spec"]
    cfg = spec["cfg"]
    tmpl = interop.train_state(runs["state0"], device="cpu")
    one = Checkpointer(spec["ckpt_dir"]).restore_state(tmpl)
    b2 = {k: torch.as_tensor(v) for k, v in runs["src"].batch(2).items()}
    _, m = ts.make_train_step(cfg, runs["topt"])(one, b2)
    assert m["loss"] == pytest.approx(want, rel=RTOL)
    names = [os.path.join(d, "step_00000002") for d in
             (spec["ckpt_dir"], spec["single_dir"])]
    metas = []
    for n in names:
        with open(os.path.join(n, "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]
    with np.load(os.path.join(names[0], "arrays.npz")) as a, \
            np.load(os.path.join(names[1], "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gather_from_model_keeps_the_ranks_slice(runs, scenario):
    """Forward: every model rank's vector in rank order; backward: the
    rank's own slice of the gradient."""
    tp = SCENARIOS[scenario][1]
    whole = np.concatenate([np.arange(6.0) + 10 * r for r in range(tp)])
    for rank in runs[scenario]["ranks"]:
        y, grad, r = rank["gather"]
        np.testing.assert_array_equal(y, whole)
        np.testing.assert_array_equal(grad, np.arange(6.0) + 6 * r)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_rank_holds_its_share(runs, scenario):
    """Each rank's params are a shard: at most the whole divided by the
    model axis plus the leaves every rank holds whole."""
    from repro_torch.distributed import sharding
    spec = runs[scenario]["spec"]
    tp = spec["mesh"][1]
    cfg = spec["cfg"]
    shd = sharding.state_shardings(cfg, Mesh(("data", "model"), spec["mesh"],
                                             0))
    flags = _leaves(sharding.shard_flags(shd.params))
    sizes = [a.nbytes for a in _leaves(runs["state0"].params)]
    want = sum(n // tp if f else n for n, f in zip(sizes, flags))
    for rank in runs[scenario]["ranks"]:
        assert rank["local_bytes"] == want < sum(sizes)


# -------------------------------------------------------------- launcher
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_mesh_single_on_a_wrong_group_names_256(monkeypatch):
    """``--mesh single`` starts the group from torchrun's environment; a
    group of one rank exits non-zero naming the 256 ranks it needs, and
    the group is torn down."""
    import torch.distributed as tdist
    from repro_torch.launch import train
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                    "--mesh", "single"])
    assert e.value.code not in (0, None)
    assert "256" in str(e.value.code)
    assert not tdist.is_initialized()


# -------------------------------------------------------------- refusals
def _dist(shape=(2, 2)):
    return DistContext(Mesh(("data", "model"), shape, rank=0))


@pytest.mark.parametrize("arch", ["gpt2-small", "deepseek-moe-16b",
                                  "rwkv6-3b", "zamba2-1.2b",
                                  "whisper-large-v3", "internvl2-2b"])
def test_other_families_refuse_to_train_sharded(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import GPT2_SMALL_SMOKE
    from repro_torch.data.pipeline import SyntheticLM as Src
    from repro_torch.training import deferred, step as ts, train_loop
    cfg = (GPT2_SMALL_SMOKE if arch == "gpt2-small"
           else get_config(arch, smoke=True))
    shape = (2, 2)
    if cfg.family == "moe":
        # the MoE family trains expert-parallel where its experts split
        # evenly over the model axis: 6 experts over 4 do not
        cfg, shape = dataclasses.replace(cfg, num_experts=6), (1, 4)
    _, topt = _opts()
    builds = [lambda: ts.make_train_step(cfg, topt, dist=_dist(shape)),
              lambda: deferred.make_train_step_deferred(cfg, topt,
                                                        _dist(shape)),
              lambda: ts.init_state(cfg, 0, "cpu", dist=_dist(shape))]
    if cfg.family in ("dense", "vlm", "audio", "ssm", "hybrid"):
        # the two-matrix MLP, the VLM, whisper and the recurrent
        # families train sharded: the step, the deferred step and the
        # sharded state build (the loop would reach a collective, and
        # this mesh starts no group)
        for build in builds:
            build()
        return
    builds.append(lambda: train_loop.train(
        cfg, topt, Src(cfg.vocab_size, 8, 4),
        train_loop.TrainLoopConfig(total_steps=1), device="cpu",
        dist=_dist(shape)))
    for build in builds:
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
            build()


def test_sharded_layout_keeps_whole_blocks():
    """A BLaST weight splits only where its block mask splits: d_ff 96
    in blocks of 16 (6 block-columns) over a model axis of 4 stays whole,
    while d_ff 128 (8) splits."""
    from repro_torch.distributed import sharding
    from repro_torch.core import sparse_mlp as sm
    for d_ff, split in ((96, False), (128, True)):
        cfg = port_cfg(dataclasses.replace(_jcfg(), d_ff=d_ff))
        sp = sharding.train_specs(cfg, Mesh(("data", "model"), (1, 4), 0))
        for path, ms in sp["masks"].items():
            assert sm.get_path(sp["params"], path) == ms
            assert sharding.model_sharded(ms) == split, (d_ff, path)
