"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference (``repro/models/moe.py``) on the two MoE ``--arch`` smoke
configs: the same numpy inputs through both. Routing indices bitwise (a
differing index only where the reference's two probabilities around it
are within 1e-6: a near-tie), f32 outputs within 1e-5, the capacity and
its drops at the default ``capacity_factor``, the ``expert_offset``
split, dense, masked (STE) and packed expert weights, the shared
experts, the expert-batched plain kernels against a per-expert loop, the
packed export bitwise, and the training loss with its aux term and its
gradients."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_transformer import port_cfg, serving_params  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import topk as jtopk  # noqa: E402
from repro.models import moe as jmoe, registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import packing as tpacking, topk as ttopk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as tmoe, registry as treg  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

MOE = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_TIE = 1e-6
# gradients sum over every token and layer, and the reference's smoke
# init makes attention sharp (tests/test_torch_train.py): within 1e-4 of
# each leaf's magnitude (the largest seen, the embedding's, 6e-5)
GRAD_REL = 1e-4


def _cfgs(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    return jcfg, port_cfg(jcfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(cfg, rng, e=None):
    e = e or cfg.num_experts
    d, f = cfg.d_model, cfg.moe_d_ff
    return [(rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((e, d, f), (e, d, f), (e, f, d))]


def _route_inputs(cfg, rng, t=37, skew=0.0):
    x = (rng.standard_normal((t, cfg.d_model)) + 0.5).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)).astype(
        np.float32)
    # x's mean is 0.5, so this adds about ``skew`` to expert 0's logit:
    # it loads expert 0 past its capacity
    router[:, 0] += 2.0 * skew / cfg.d_model
    return x, router


def _assert_idx_or_near_tie(got, want, probs):
    """Equal indices, or a difference only at a near-tie of the
    reference's sorted probabilities."""
    sp = -np.sort(-probs, axis=-1)
    for t, j in zip(*np.nonzero(got != want)):
        gaps = [sp[t, j] - sp[t, j + 1]]
        if j:
            gaps.append(sp[t, j - 1] - sp[t, j])
        assert min(gaps) < NEAR_TIE, (t, j, gaps)


@pytest.mark.parametrize("arch", MOE)
def test_specs_paths_counts_and_flags_match(arch):
    for smoke in (True, False):
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        tcfg = port_cfg(jcfg)
        flat = {k: (s.shape, s.axes, s.init, s.scale)
                for k, s in _flatten(ttr.param_specs(tcfg))}
        assert flat == {k: (s.shape, s.axes, s.init, s.scale)
                        for k, s in _flatten(jtr.param_specs(jcfg))}
        assert ttr.sparse_paths(tcfg) == jtr.sparse_paths(jcfg)
        for active in (False, True):
            assert (treg.count_params(tcfg, active_only=active)
                    == jreg.count_params(jcfg, active_only=active))
        assert treg.count_params(tcfg, True) < treg.count_params(tcfg)
        assert treg.module_for(tcfg) is ttr
        for fn in ("supports_prefill_chunk", "supports_paged",
                   "supports_mixed"):
            assert getattr(treg, fn)(tcfg) == getattr(jreg, fn)(jcfg) \
                is True


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_expert_weights_init_by_their_own_fan_in():
    """The (E, d, f) and (E, f, d) leaves draw at 1/sqrt(d) and
    1/sqrt(f) times their scale, never 1/sqrt(E); the router at
    1/sqrt(d)."""
    _, tcfg = _cfgs("deepseek-moe-16b")
    tcfg = dataclasses.replace(tcfg, d_model=256, moe_d_ff=512)
    p = treg.init_params(tcfg, 0, "cpu")["layers"]["mlp"]
    d, f, n = tcfg.d_model, tcfg.moe_d_ff, tcfg.num_layers
    want = {"router": d ** -0.5, "w_gate": d ** -0.5, "w_up": d ** -0.5,
            "ws_gate": d ** -0.5,
            "w_down": f ** -0.5 / (2 * n) ** 0.5,
            "ws_down": (f * tcfg.num_shared_experts) ** -0.5
            / (2 * n) ** 0.5}
    for k, std in want.items():
        assert abs(float(p[k].std()) / std - 1) < 0.05, k


@pytest.mark.parametrize("skew", [0.0, 3.0], ids=["plain", "skewed"])
@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch, skew):
    jcfg, tcfg = _cfgs(arch)
    x, router = _route_inputs(jcfg, np.random.default_rng(1), skew=skew)
    jv, ji, ja = jmoe.route(jcfg, jnp.asarray(x), jnp.asarray(router))
    tv, ti, ta = tmoe.route(tcfg, _t(x), _t(router))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router)))
    _assert_idx_or_near_tie(ti.numpy(), np.asarray(ji), probs)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("t", [1, 8, 37, 128, 1024])
def test_capacity_matches_reference(t):
    for arch in MOE:
        for smoke in (True, False):
            jcfg = jconfigs.get_config(arch, smoke=smoke)
            assert tmoe.capacity(port_cfg(jcfg), t) == jmoe.capacity(jcfg, t)


def test_capacity_drops_tokens_as_the_reference():
    """The reference's drop case (tests/test_moe.py): capacity 1, every
    token on expert 0; the same kept row, nothing else."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b")
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.01, top_k=1)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.01, top_k=1)
    t, d, e, f = 64, jcfg.d_model, jcfg.num_experts, jcfg.moe_d_ff
    x = np.full((t, d), 0.1, np.float32)
    ws = [np.full(s, 0.01, np.float32) for s in ((e, d, f), (e, d, f),
                                                 (e, f, d))]
    vals, idx = np.ones((t, 1), np.float32), np.zeros((t, 1), np.int32)
    want = np.asarray(jmoe.local_expert_forward(
        jcfg, jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx),
        *map(jnp.asarray, ws)))
    got = tmoe.local_expert_forward(tcfg, _t(x), _t(vals), _t(idx).long(),
                                    *map(_t, ws)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.any(got != 0, axis=-1).sum()
            == tmoe.capacity(tcfg, t) == 1)


def _masks(cfg, rng, e):
    spec = cfg.blast
    kb, nb = cfg.d_model // spec.b_in, cfg.moe_d_ff // spec.b_out
    keep = max(1, kb // 3)

    def one(shape, k):
        return ttopk.topk_mask_per_col(torch.from_numpy(
            rng.random(shape).astype(np.float32)), k).numpy()
    return {"w_gate": one((e, kb, nb), keep), "w_up": one((e, kb, nb), keep),
            "w_down": one((e, nb, kb), max(1, nb // 3))}


def _packs(cfg, ws, masks):
    """(reference packs, port packs) of the masked expert weights."""
    spec = cfg.blast
    dims = {"w_gate": (spec.b_in, spec.b_out), "w_up": (spec.b_in,
                                                        spec.b_out),
            "w_down": (spec.b_out, spec.b_in)}
    jp, tp = [], []
    for name, w in zip(("w_gate", "w_up", "w_down"), ws):
        bi, bo = dims[name]
        m = masks[name]
        wm = np.asarray(jtopk.apply_block_mask(jnp.asarray(w),
                                               jnp.asarray(m), bi, bo))
        nnz = int(m.sum(-2).max())
        jpk = jpacking.pack_stacked(jnp.asarray(wm), jnp.asarray(m), bi, bo,
                                    nnz)
        tpk = tpacking.pack(_t(wm), _t(m), bi, bo, nnz)
        np.testing.assert_array_equal(tpk.idx.numpy(), np.asarray(jpk.idx))
        np.testing.assert_array_equal(tpk.blocks.numpy(),
                                      np.asarray(jpk.blocks))
        jp.append(jpk)
        tp.append(tpk)
    return jp, tp


@pytest.mark.parametrize("mode", ["dense", "masked", "packed"])
@pytest.mark.parametrize("arch", MOE)
def test_local_expert_forward_matches_reference(arch, mode, monkeypatch):
    """At the default capacity factor, on a router skewed so that expert
    0 overflows its capacity (drops included)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    x, router = _route_inputs(jcfg, rng, t=24, skew=4.0)
    jv, ji, _ = jmoe.route(jcfg, jnp.asarray(x), jnp.asarray(router))
    loads = np.bincount(np.asarray(ji).ravel(), minlength=jcfg.num_experts)
    assert loads.max() > jmoe.capacity(jcfg, 24)        # tokens drop
    ws = _weights(jcfg, rng)
    masks = _masks(tcfg, rng, jcfg.num_experts)
    jw, tw, jm, tm = ([jnp.asarray(w) for w in ws], [_t(w) for w in ws],
                      None, None)
    if mode == "masked":
        jm = {k: jnp.asarray(v) for k, v in masks.items()}
        tm = {k: _t(v) for k, v in masks.items()}
    if mode == "packed":
        jw, tw = _packs(tcfg, ws, masks)
        # the kernels take a contiguous (E, C, D) expert batch
        apply = ops.sparse_mlp_apply

        def checked(x, *a, **kw):
            assert x.is_contiguous() and x.shape[0] == jcfg.num_experts
            return apply(x, *a, **kw)
        monkeypatch.setattr(ops, "sparse_mlp_apply", checked)
    want = jmoe.local_expert_forward(jcfg, jnp.asarray(x), jv, ji, *jw,
                                     masks=jm)
    got = tmoe.local_expert_forward(tcfg, _t(x), _t(jv), _t(ji).long(),
                                    *tw, masks=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_expert_offset_split_sums_to_full(arch):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    x, router = _route_inputs(jcfg, rng, t=32)
    ws = [_t(w) for w in _weights(jcfg, rng)]
    tv, ti, _ = tmoe.route(tcfg, _t(x), _t(router))
    full = tmoe.local_expert_forward(tcfg, _t(x), tv, ti, *ws)
    h = jcfg.num_experts // 2
    parts = [tmoe.local_expert_forward(tcfg, _t(x), tv, ti,
                                       *[w[sl] for w in ws],
                                       expert_offset=off)
             for sl, off in ((slice(None, h), 0), (slice(h, None), h))]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(),
                               **TOL)
    jv, ji, _ = jmoe.route(jcfg, jnp.asarray(x), jnp.asarray(router))
    jpart = jmoe.local_expert_forward(
        jcfg, jnp.asarray(x), jv, ji, *[jnp.asarray(w[h:]) for w in ws],
        expert_offset=h)
    np.testing.assert_allclose(parts[1].numpy(), np.asarray(jpart), **TOL)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_and_shared_experts_match(arch, packed):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = serving_params(jcfg, packed=packed)
    jl = {k: (jpacking.PackedBCSC(v.blocks[0], v.idx[0], v.kb)
              if isinstance(v, jpacking.PackedBCSC) else v[0])
          for k, v in jp["layers"]["mlp"].items()}
    tl = ttr._layer_view(tp["layers"], 0)["mlp"]
    x = np.random.default_rng(4).standard_normal(
        (3, 7, jcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_forward(jcfg, jl, jnp.asarray(x))
    got, taux = tmoe.moe_forward(tcfg, tl, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if jcfg.num_shared_experts:
        np.testing.assert_allclose(
            tmoe.shared_expert_forward(tcfg, _t(x), tl).numpy(),
            np.asarray(jmoe.shared_expert_forward(jcfg, jnp.asarray(x), jl)),
            **TOL)
    # the expert-parallel path takes a DistContext, not an axis name
    with pytest.raises(TypeError, match="DistContext"):
        tmoe.moe_forward(tcfg, tl, _t(x), axis_name="model")


@pytest.mark.parametrize("arch", MOE)
def test_calls_count_layer_calls_by_tokens_and_capacity(arch):
    """``moe.CALLS`` adds one per MoE layer call under (tokens in the
    call, the reference's capacity for that count): a forward over L
    layers adds L under one key, a second token count a second key."""
    jcfg, tcfg = _cfgs(arch)
    _, tp = serving_params(jcfg, packed=False)
    rng = np.random.default_rng(5)
    tmoe.CALLS.clear()
    for b, s in ((2, 9), (1, 3)):
        toks = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
        treg.forward(tcfg, tp, _t(toks))
    assert dict(tmoe.CALLS) == {
        (t, jmoe.capacity(jcfg, t)): tcfg.num_layers for t in (18, 3)}
    tmoe.CALLS.clear()


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("joint", [False, True], ids=["split", "joint"])
def test_plain_expert_batch_equals_per_expert_loop(joint, act):
    """The expert-batched plain ``bspmm`` and fused GLU (one batched
    gather and einsum) against the unbatched plain versions looped over
    the experts (the same products summed in f32)."""
    rng = np.random.default_rng(5)
    e, c, d, f, b = 6, 5, 64, 48, 16
    masks = {k: ttopk.topk_mask_per_col(torch.from_numpy(
        rng.random(s).astype(np.float32)), 2)
        for k, s in (("g", (e, d // b, f // b)), ("u", (e, d // b, f // b)),
                     ("d", (e, f // b, d // b)))}
    if joint:
        masks["u"] = masks["g"]
    w = {k: torch.from_numpy((rng.standard_normal(
        (e, d, f) if k != "d" else (e, f, d)) * 0.1).astype(np.float32))
        for k in masks}
    p = {k: tpacking.pack(w[k], masks[k], b, b, 2) for k in w}
    pg, pu = tpacking.mark_joint(p["g"], p["u"])
    assert pg.joint == joint
    x = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    h = ops.fused_glu_plain(x, pg, pu, act)
    y = ops.bspmm_plain(h, p["d"])
    assert h.shape == (e, c, f) and y.shape == (e, c, d)
    for i in range(e):
        hi = ops.fused_glu_plain(x[i], pg.layer(i), pu.layer(i), act)
        np.testing.assert_allclose(h[i].numpy(), hi.numpy(), **TOL)
        np.testing.assert_allclose(
            y[i].numpy(), ops.bspmm_plain(h[i], p["d"].layer(i)).numpy(),
            **TOL)
    np.testing.assert_allclose(
        ops.sparse_mlp_apply(x, pg, pu, p["d"], act=act).numpy(),
        y.numpy(), **TOL)
    assert ops.flops_bspmm(c, p["d"]) == 2 * c * e * (d // b) * 2 * b * b


def test_pack_stacked_equals_a_pack_per_matrix():
    """The vectorised pack over (L, E) leading axes equals one ``pack``
    per matrix, bitwise, including an unbalanced (padded) column."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((2, 3, 64, 32)).astype(
        np.float32))
    m = ttopk.topk_mask_per_col(torch.from_numpy(
        rng.random((2, 3, 8, 4)).astype(np.float32)), 3)
    m[1, 2, :, 0] = False
    m[1, 2, 5, 0] = True
    p = tpacking.pack(w, m, 8, 8, 3)
    assert p.blocks.shape == (2, 3, 4, 3, 8, 8) and p.idx.shape == (2, 3, 4,
                                                                    3)
    for i in range(2):
        for j in range(3):
            q = tpacking.pack(w[i, j], m[i, j], 8, 8, 3)
            assert torch.equal(p.blocks[i, j], q.blocks)
            assert torch.equal(p.idx[i, j], q.idx)


@pytest.mark.parametrize("joint", [False, True], ids=["magnitude", "joint"])
@pytest.mark.parametrize("arch", MOE)
def test_pack_params_matches_reference(arch, joint):
    """``idx`` and ``blocks`` bitwise, the joint marks (``ws_*`` too) and
    ``memory_report`` bytes equal; with up taking gate's mask every
    gate/up pair packs joint on both sides."""
    jcfg, tcfg = _cfgs(arch)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jmasks = _one_shot(jcfg, params)
    if joint:
        jmasks = {k: jmasks[k.replace("_up", "_gate")] for k in jmasks}
    want = jax.device_get(jexport.pack_params(jcfg, params, jmasks))
    tparams = interop.to_torch(jax.device_get(params), device="cpu")
    got = texport.pack_params(tcfg, tparams,
                              {k: _t(v) for k, v in jmasks.items()})
    for leaf, wl in want["layers"]["mlp"].items():
        gl = got["layers"]["mlp"][leaf]
        if isinstance(wl, jpacking.PackedBCSC):
            np.testing.assert_array_equal(gl.idx.numpy(), np.asarray(wl.idx))
            np.testing.assert_array_equal(
                gl.blocks.view(torch.int16).numpy(),
                np.asarray(wl.blocks).view(np.int16))
            assert gl.kb == wl.kb
            assert gl.joint == getattr(wl, "joint", False) == (
                joint and leaf in ("w_gate", "w_up", "ws_gate", "ws_up"))
        else:
            np.testing.assert_array_equal(
                gl.view(torch.int16).numpy(), np.asarray(wl).view(np.int16))
    assert (texport.memory_report(tcfg, got)["bytes"]
            == jexport.memory_report(jcfg, want)["bytes"])


def _one_shot(jcfg, params, s=0.8):
    from repro.core import sparse_mlp as jsm
    from repro.core.prune_grow import initial_mask
    spec = dataclasses.replace(jcfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in jreg.sparse_paths(jcfg):
        w = jsm.get_path(params, path)
        bi, bo = jsm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        fn = lambda wi: initial_mask(pspec, wi)  # noqa: E731
        for _ in range(w.ndim - 2):
            fn = jax.vmap(fn)
        masks[path] = jax.device_get(fn(w))
    return masks


@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` with the aux term (loss + 0.01 aux) and the gradients
    of every leaf on masked-dense params (magnitude masks at s = 0.5)."""
    jcfg, tcfg = _cfgs(arch)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    masks = _one_shot(jcfg, params, s=0.5)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)

    def jloss(p):
        return jstep.loss_fn(jcfg, p, masks, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels)})
    (jl, (_, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tparams = interop.to_torch(jax.device_get(params), device="cpu")
    leaves = jax.tree_util.tree_map(lambda a: a.requires_grad_(True),
                                    tparams)
    tl, (_, taux) = tstep.loss_fn(
        tcfg, leaves, {k: _t(v) for k, v in masks.items()},
        {"tokens": _t(toks), "labels": _t(labels)})
    taux, tlv = float(taux.detach()), float(tl.detach())
    assert taux > 0
    np.testing.assert_allclose(taux, float(jaux), rtol=1e-5)
    np.testing.assert_allclose(tlv, float(jl), rtol=1e-5)
    base = tstep.distill.distill_loss(tstep.registry.forward(
        tcfg, tparams, _t(toks),
        masks={k: _t(v) for k, v in masks.items()})[0], _t(labels))
    np.testing.assert_allclose(tlv - float(base.detach()), 0.01 * taux,
                               rtol=1e-4)
    tl.backward()
    for path, g in _flatten(jax.device_get(jg)):
        w = leaves
        for k in path.split("/"):
            w = w[k]
        np.testing.assert_allclose(
            w.grad.numpy(), g, rtol=1e-5,
            atol=GRAD_REL * float(np.abs(g).max()), err_msg=path)


def test_set_path_holds_no_reference_cycle():
    """``sparse_mlp.set_path`` copies the dicts along the path and keeps
    no reference cycle: with the garbage collector off, a value set into
    a tree is freed as soon as the tree is (the export replaces every
    sparse leaf through it; a cycle held each masked f32 copy until a
    collection ran, GBs at the MoE widths)."""
    import gc
    import weakref
    from repro_torch.core import sparse_mlp as sm
    tree = {"a": {"b": torch.zeros(3), "c": 1}, "d": 2}
    value = torch.ones(3)
    ref = weakref.ref(value)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = sm.set_path(tree, "a/b", value)
        assert out["a"]["b"] is value and out["d"] == 2
        assert out["a"] is not tree["a"] and tree["a"]["b"] is not value
        del out, value
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
