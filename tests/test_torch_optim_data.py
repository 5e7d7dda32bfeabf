"""The port's optimizer, schedule, data sources and distillation losses
against the reference, on the same numpy inputs.

Host scalars of the schedule (sparsity, grow budget, learning rate) are
held bitwise against the reference's values under ``jax.jit`` on a
traced step, which is how its train step computes them; batches are
bitwise-equal; f32 tensor outputs agree within 1e-6 of their magnitude
(AdamW's update divides by sqrt(v) + eps, so a few elements with
gradients near eps carry the last bits of the sums' order further)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distill as jdistill  # noqa: E402
from repro.core import prune_grow as jpg, schedule as jsc  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import distill as tdistill  # noqa: E402
from repro_torch.core import prune_grow as tpg, schedule as tsc  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("s_init,s_max,total,decay", [
    (0.0, 0.75, 20, 0), (0.0, 0.8, 12, 0), (0.1, 0.9, 37, 3),
    (0.0, 0.8, 10_000, 0)])
def test_sparsity_at_matches_jitted_reference_bitwise(s_init, s_max, total,
                                                      decay):
    f = jax.jit(lambda s: jsc.sparsity_at(s, s_init=s_init, s_max=s_max,
                                          total_steps=total, decay=decay))
    for step in list(range(0, min(total, 60) + 2)) + [total // 2, total]:
        want = float(f(jnp.int32(step)))
        assert tsc.sparsity_at(step, s_init=s_init, s_max=s_max,
                               total_steps=total, decay=decay) == want, step


@pytest.mark.parametrize("total,gf,gf_end", [(20, 0.3, 0.0), (12, 0.3, 0.0),
                                             (100, 0.5, 0.1)])
def test_grow_count_matches_jitted_reference(total, gf, gf_end):
    jspec = jpg.BlastSpec(total_steps=total, grow_frac=gf,
                          grow_frac_end=gf_end)
    tspec = tpg.BlastSpec(**dataclasses.asdict(jspec))
    f = jax.jit(lambda s, k: jpg.grow_count(jspec, s, k))
    for step in range(0, total + 2):
        for kept in (1, 2, 3, 4, 10, 13, 16, 64):
            want = int(f(jnp.int32(step), jnp.int32(kept)))
            assert tpg.grow_count(tspec, step, kept) == want, (step, kept)


def test_refresh_cadence_helpers():
    for step in range(0, 30):
        for size in (0, 1, 4, 5):
            assert tsc.is_refresh_step(step, size) == \
                jsc.is_refresh_step(step, size)
            assert tsc.steps_since_refresh(step, size) == \
                jsc.steps_since_refresh(step, size)


# ---------------------------------------------------------------- AdamW
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def _close(got, want, rel=1e-6):
    for g, w in zip(tadam.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rel,
                                   atol=rel * float(np.abs(w).max() + 1e-30))


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    c = jadam.AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=20,
                          grad_clip=clip)
    tc = tadam.AdamWConfig(**dataclasses.asdict(c))
    p, m, v = _tree(0), _tree(1), _tree(2)
    v = jax.tree_util.tree_map(np.abs, v)
    jp, jo = jax.tree_util.tree_map(jnp.asarray, p), {
        "m": jax.tree_util.tree_map(jnp.asarray, m),
        "v": jax.tree_util.tree_map(jnp.asarray, v)}
    tp, to = interop.to_torch(p), {"m": interop.to_torch(m),
                                   "v": interop.to_torch(v)}
    jupdate = jax.jit(lambda g, o, p, s: jadam.update(c, g, o, p, s))
    for step in range(6):
        g = _tree(10 + step)
        jp, jo, jm = jupdate(jax.tree_util.tree_map(jnp.asarray, g), jo, jp,
                             jnp.int32(step))
        tp, to, tm = tadam.update(tc, interop.to_torch(g), to, tp, step)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == float(jm["lr"])
        _close(tp, jp)
        _close(to["m"], jo["m"])
        _close(to["v"], jo["v"])


def test_adamw_update_leaves_its_inputs_unchanged():
    c = tadam.AdamWConfig(peak_lr=1e-2, warmup_steps=0)
    p = interop.to_torch(_tree(0))
    o = tadam.init(p)
    before = [x.clone() for x in tadam.tree_leaves(p)]
    tadam.update(c, interop.to_torch(_tree(1)), o, p, 3)
    for x, y in zip(tadam.tree_leaves(p), before):
        assert torch.equal(x, y)
    assert all(not bool(x.any()) for x in tadam.tree_leaves(o))


def test_lr_at_matches_jitted_reference_bitwise():
    for c in (jadam.AdamWConfig(),
              jadam.AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                total_steps=12),
              jadam.AdamWConfig(peak_lr=1.0, warmup_steps=10,
                                total_steps=100, end_lr_frac=0.1)):
        tc = tadam.AdamWConfig(**dataclasses.asdict(c))
        f = jax.jit(lambda s: jadam.lr_at(c, s))
        for step in list(range(0, 40)) + [c.total_steps, c.total_steps + 5]:
            assert tadam.lr_at(tc, step) == float(f(jnp.int32(step))), step


def test_global_norm_and_clip():
    g = _tree(3)
    clipped, norm = tadam.clip_by_global_norm(interop.to_torch(g), 1.0)
    jclipped, jnorm = jadam.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    _close(clipped, jclipped)
    assert float(tadam.global_norm(clipped)) <= 1.0 + 1e-5


def test_mask_moments_zeroes_pruned_blocks():
    spec = jpg.BlastSpec(b_in=4, b_out=8)
    rng = np.random.default_rng(0)
    opt = {w: {"layers": {"mlp": {
        "w_gate": rng.standard_normal((2, 8, 16)).astype(np.float32),
        "w_down": rng.standard_normal((2, 16, 8)).astype(np.float32)}}}
        for w in ("m", "v")}
    masks = {"layers/mlp/w_gate": rng.random((2, 2, 2)) < 0.5,
             "layers/mlp/w_down": rng.random((2, 2, 2)) < 0.5}
    want = jadam.mask_moments(
        jax.tree_util.tree_map(jnp.asarray, opt),
        {k: jnp.asarray(v) for k, v in masks.items()}, spec)
    got = tadam.mask_moments(
        {k: interop.to_torch(v) for k, v in opt.items()},
        {k: torch.from_numpy(v) for k, v in masks.items()},
        tpg.BlastSpec(**dataclasses.asdict(spec)))
    for w in ("m", "v"):
        for g, x in zip(tadam.tree_leaves(got[w]),
                        jax.tree_util.tree_leaves(want[w])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("step,rank,world", [(0, 0, 1), (7, 1, 2),
                                             (123, 3, 4)])
def test_synthetic_batches_bitwise(step, rank, world):
    want = jdata.SyntheticLM(256, seq_len=16, global_batch=8,
                             seed=5).batch(step, rank, world)
    got = tdata.SyntheticLM(256, seq_len=16, global_batch=8,
                            seed=5).batch(step, rank, world)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_memmap_batches_bitwise_and_make_source(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 300, size=5000).astype(
        np.uint16).tofile(path)
    for step in (0, 4):
        want = jdata.MemmapTokens(str(path), 256, 32, 4, seed=2).batch(step)
        got = tdata.MemmapTokens(str(path), 256, 32, 4, seed=2).batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    cfg = type("Cfg", (), {"vocab_size": 256})()
    shape = ShapeConfig("t", 32, 4, "train")
    assert isinstance(tdata.make_source(cfg, shape, str(path)),
                      tdata.MemmapTokens)
    assert isinstance(tdata.make_source(cfg, shape), tdata.SyntheticLM)
    with pytest.raises(ValueError, match="shorter"):
        tdata.MemmapTokens(str(path), 256, 6000, 4)


# -------------------------------------------------------------- distill
def test_distill_losses_match_reference():
    rng = np.random.default_rng(0)
    s = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    t = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    labels[0, 1] = -100
    ts, tt, tl = (torch.from_numpy(a) for a in (s, t, labels))
    js, jt, jl = (jnp.asarray(a) for a in (s, t, labels))
    pairs = [(tdistill.cross_entropy(ts, tl), jdistill.cross_entropy(js, jl)),
             (tdistill.kl_to_teacher(ts, tt, 2.0),
              jdistill.kl_to_teacher(js, jt, 2.0)),
             (tdistill.distill_loss(ts, tl, tt, alpha=0.5, beta=0.7),
              jdistill.distill_loss(js, jl, jt, alpha=0.5, beta=0.7)),
             (tdistill.distill_loss(ts, tl), jdistill.distill_loss(js, jl))]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(tdistill.kl_to_teacher(ts, ts)) == pytest.approx(0.0,
                                                                 abs=1e-6)
