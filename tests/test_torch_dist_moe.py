"""Expert parallelism on the CPU (``dist=`` on the MoE family): gloo
ranks against the reference's single-device functions.

One scenario of 4 ranks, started once (``_torch_dist_rank.py``,
``ep_scenario``; a ``file://`` store under the test's temporary
directory): ranks 0-1 form a (data 1, model 2) mesh that runs
deepseek-moe-16b's smoke config (8 experts, top 2, one shared expert)
and ranks 2-3 another that runs qwen3-moe-235b-a22b's (no shared
expert), both cut to 2 layers. On each pair: ``moe_forward(axis_name=
dist)`` on layer 0 of the dense and of the packed (s = 0.7, f32) params,
the stream whole and split along S, against the reference's
``moe_forward`` on one device (f32 within 1e-5); the packed model served
through ``serve_loop.generate`` (greedy and sampled) and the paged
``Engine`` (phased, mixed, prefix-cached), equal to the port's own
one-device streams, next-token logits and engine host states, with equal
lockstep digests on both ranks; one train step with ``sp`` on and off
against the reference's ``make_train_step`` on the global batch (loss
and gradient norm to rel 1e-5, params to abs 5e-5, masks bitwise) and
the sp step's gradients against the reference's. Then all four ranks,
(data 2, model 2), one step of each config with ``sp`` on and off,
against the reference's step over two microbatches: each data rank
routes its own rows at their capacity and the aux is averaged, as the
reference's shard_map does. Two planted faults in the ranks (every
rank's expert offset left at 0; the aux gradient counted on every rank)
and one here (an expert pack split on its experts and its ``nb``, the
reference's ``abstract_packed_params`` layout) must miss those bars.
The sharding rules, the pack shards and the refusals run in-process.

The weights are the port's seeded init (true fan-in), handed to the
reference, as in ``test_torch_dist_train.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.packing import PackedBCSC as JPacked  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.packing import PackedBCSC  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from test_torch_dist_serving import ENGINE, NEW, _traffic  # noqa: E402
from test_torch_engine import _assert_same_or_near_tie  # noqa: E402
from test_torch_engine import _port_margin  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
LR, RTOL, PARAM_ATOL, FWD_TOL = 1e-4, 1e-5, 5e-5, 1e-5
# a gradient leaf within 1e-5 of its magnitude (sums over every token)
GRAD_REL = 1e-5
SPARSITY = 0.7
MODES = tuple(ranks.MODES)


def _jcfg(arch):
    return dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               num_layers=2)


def _opts():
    kw = dict(peak_lr=LR, total_steps=20, warmup_steps=0)
    return jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)


def _initial_states(jcfg):
    """(the reference's TrainState, the same state as numpy) from the
    port's seeded init: all-kept masks, zero moments, step 0."""
    from repro_torch.training import step as ts
    st = ts.init_state(port_cfg(jcfg), 0, "cpu")
    host = types.SimpleNamespace(
        step=np.asarray(0, np.int32), params=interop.to_numpy(st.params),
        opt_state={k: interop.to_numpy(st.opt_state[k]) for k in ("m", "v")},
        masks=interop.to_numpy(st.masks))
    # jitted: the state's values are replaced below, only its structure
    # is kept, and op by op the init takes seconds on the CPU
    js = jax.jit(lambda k: jts.init_state(jcfg, k))(jax.random.PRNGKey(0))
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    js = dataclasses.replace(js, params=as_j(host.params),
                             opt_state=as_j(host.opt_state),
                             masks=as_j(host.masks))
    return js, host


def _packed(cfg, params):
    """The launcher's one-shot magnitude prune at ``SPARSITY`` of the
    port's init, packed in f32, as numpy (packs as namespaces)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    from repro_torch.models import registry
    spec = dataclasses.replace(cfg.blast, s_init=SPARSITY, s_max=SPARSITY)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    tree = texport.pack_params(cfg, params, masks, dtype=torch.float32)
    return _numpy_tree(tree)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return types.SimpleNamespace(
            blocks=tree.blocks.numpy(), idx=tree.idx.numpy(), kb=tree.kb,
            joint=tree.joint)
    return tree.numpy()


def _layer0(tree):
    """Layer 0's MLP leaves of a numpy tree, as the reference's arrays
    (packs as its ``PackedBCSC``)."""
    out = {}
    for k, v in tree["layers"]["mlp"].items():
        if isinstance(v, types.SimpleNamespace):
            out[k] = JPacked(blocks=jnp.asarray(v.blocks[0]),
                             idx=jnp.asarray(v.idx[0]), kb=v.kb,
                             joint=v.joint)
        else:
            out[k] = jnp.asarray(v[0])
    return out


def _one_device(cfg, packed, sv):
    """The port's own single-device serving of the packed tree: the
    streams, draws, logits and engine runs that every rank must give."""
    from repro_torch.serving import engine, serve_loop
    params = interop.to_torch(packed, device="cpu")
    out = {}
    with torch.inference_mode():
        out["loop"] = serve_loop.generate(cfg, params, sv["equal"],
                                          max_new_tokens=NEW,
                                          device="cpu")[0]
        gen = torch.Generator(device="cpu")
        gen.manual_seed(7)
        out["sampled"] = serve_loop.generate(
            cfg, params, sv["equal"], max_new_tokens=NEW, temperature=0.8,
            generator=gen, device="cpu")[0]
        out["logits"] = [ranks.full_logits(cfg, params, p, None, "cpu")
                         for p in sv["logit_prompts"]]
    for mode in MODES:
        eng = engine.Engine(cfg, params, device="cpu", **ENGINE,
                            **ranks.MODES[mode])
        streams, snaps = ranks.drive(
            eng, sv["prefix_prompts" if mode == "prefix" else "ragged"], NEW)
        out[mode] = {"streams": streams, "snaps": snaps,
                     "digest": eng.lockstep_digest}
    out["params"] = params
    return out


def _ref_grads(jcfg, js, batch):
    def loss(p):
        return jts.loss_fn(jcfg, p, js.masks, batch)[0]
    return jax.device_get(jax.jit(jax.grad(loss))(js.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 4 ranks, compute the reference and the port's single
    device meanwhile, collect."""
    jopt, topt = _opts()
    src = SyntheticLM(256, 16, 8, seed=1)
    models, ref = {}, {}
    rng = np.random.default_rng(11)
    for arch in ARCHS:
        jcfg = _jcfg(arch)
        cfg = port_cfg(jcfg)
        js, host = _initial_states(jcfg)
        full = interop.to_torch(host.params, device="cpu")
        packed = _packed(cfg, full)
        sv = dict(cfg=cfg, params=packed, engine=ENGINE, new=NEW,
                  modes=MODES, **_traffic(cfg.vocab_size))
        x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        models[arch] = dict(cfg=cfg, state=host, params=packed, x=x,
                            serve=sv)
        ref[arch] = dict(jcfg=jcfg, js=js, host=host, packed=packed)
    d = str(tmp_path_factory.mktemp("ep"))
    procs = ranks.start(d, 4, train=dict(archs=ARCHS, models=models,
                                         opt=topt, source=src, mesh=(2, 2)),
                        scenario="ep")
    b0 = {k: jnp.asarray(v) for k, v in src.batch(0).items()}
    for arch in ARCHS:
        r = ref[arch]
        jcfg, js, m = r["jcfg"], r["js"], models[arch]
        x = jnp.asarray(m["x"])
        r["forward"] = {}
        for kind, tree in (("dense", m["state"].params),
                           ("packed", m["params"])):
            y, aux = jmoe.moe_forward(jcfg, _layer0(tree), x)
            r["forward"][kind] = (np.asarray(y), float(aux))
        r["grads"] = _ref_grads(jcfg, js, b0)
        for n in (1, 2):
            st, met = jax.jit(jts.make_train_step(jcfg, jopt,
                                                  microbatches=n))(js, b0)
            r[f"mb{n}"] = dict(metrics={k: float(v) for k, v in
                                        met.items()},
                               **jax.device_get({"params": st.params,
                                                 "masks": dict(st.masks)}))
        r["one"] = _one_device(m["cfg"], m["params"], m["serve"])
    got = ranks.collect(d, procs)
    return {"ref": ref, "ranks": {a: [r for r in got if r["arch"] == a]
                                  for a in ARCHS}, "all": got}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _forward_err(rank_outs, want, seq):
    """Max abs error of the ranks' ``moe_forward`` (their S shards
    concatenated under ``seq``) against ``want``, and of the aux."""
    ys = [r[0] for r in rank_outs]
    if seq:
        got = np.concatenate(ys, axis=1)
    else:
        got = ys[0]
        for y in ys[1:]:            # every rank holds the whole output
            assert np.array_equal(y, got)
    return (float(np.abs(got - want[0]).max()),
            max(abs(r[1] - want[1]) for r in rank_outs))


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("seq", [False, True], ids=["whole", "seq"])
@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(runs, arch, kind, seq):
    outs = [r["forward"]["out"][(kind, seq)] for r in runs["ranks"][arch]]
    err, aux_err = _forward_err(outs, runs["ref"][arch]["forward"][kind],
                                seq)
    assert err <= FWD_TOL and aux_err <= 1e-6, (err, aux_err)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_routes_every_token_to_its_experts(runs, arch):
    """Each rank holds E/2 experts, dense and packed, and every layer
    call runs at the capacity of the whole call's tokens (the S shards
    gathered first)."""
    from repro_torch.models import moe
    cfg = port_cfg(runs["ref"][arch]["jcfg"])
    tokens = 2 * 12
    for r in runs["ranks"][arch]:
        assert r["forward"]["experts"] == [cfg.num_experts // 2] * 2
        assert r["forward"]["calls"] == {
            (tokens, moe.capacity(cfg, tokens)): 4}
    assert sorted(r["model_rank"] for r in runs["ranks"][arch]) == [0, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_offset_fault_misses(runs, arch):
    """Every rank's expert offset left at 0: rank 1 routes experts
    0..E/2-1's tokens to its own experts E/2..E-1."""
    outs = [r["planted_offset"]["out"][("dense", False)]
            for r in runs["ranks"][arch]]
    err, _ = _forward_err(outs, runs["ref"][arch]["forward"]["dense"],
                          False)
    assert err > 100 * FWD_TOL, err


# ---------------------------------------------------------------- serving
def _margin(arch, runs):
    one = runs["ref"][arch]["one"]
    cfg = port_cfg(runs["ref"][arch]["jcfg"])
    return lambda seq: _port_margin(cfg, one["params"], seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_streams_equal_one_device(runs, arch):
    one = runs["ref"][arch]["one"]
    plen = _traffic(256)["equal"].shape[1]
    for r in runs["ranks"][arch]:
        for got, want in zip(r["serve"]["loop"], one["loop"]):
            _assert_same_or_near_tie(got, want, plen, _margin(arch, runs))
        np.testing.assert_array_equal(r["serve"]["sampled"], one["sampled"])
        for got, want in zip(r["serve"]["logits"], one["logits"]):
            np.testing.assert_allclose(
                got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_one_device(runs, arch, mode):
    """Streams, per-step host states and digests equal the port's single
    device engine's, call for call (capacity follows each call's
    tokens), and the ranks' digests equal each other."""
    one = runs["ref"][arch]["one"][mode]
    sv = runs["ranks"][arch][0]["serve"]
    prompts = _traffic(256)["prefix_prompts" if mode == "prefix"
                            else "ragged"]
    for r in runs["ranks"][arch]:
        got = r["serve"][mode]
        for p, g, w in zip(prompts, got["streams"], one["streams"]):
            _assert_same_or_near_tie(np.asarray(g), np.asarray(w), p.size,
                                     _margin(arch, runs))
        assert got["snaps"] == one["snaps"]
        assert got["digest"] == sv[mode]["digest"] == one["digest"]
    if mode == "prefix":
        assert sv[mode]["stats"]["prefix_hits"] > 0
    if mode == "mixed":
        assert sv[mode]["stats"]["mixed_steps"] > 0
        assert sv[mode]["stats"]["stalled_decode_steps"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_hold_half_the_experts(runs, arch):
    """A rank's weight bytes: half of every expert pack, the attention
    and vocabulary shards, the router, norms and shared experts whole."""
    cfg = port_cfg(runs["ref"][arch]["jcfg"])
    full = interop.to_torch(runs["ref"][arch]["packed"], device="cpu")
    total = texport.memory_report(cfg, full)["bytes"]
    experts = sum(texport.memory_report(cfg, {"x": v})["bytes"]
                  for k, v in full["layers"]["mlp"].items()
                  if k in ("w_gate", "w_up", "w_down"))
    want = texport.memory_report(cfg, texport.shard_params(
        cfg, full, Mesh(("data", "model"), (1, 2), 0)))["bytes"]
    for r in runs["ranks"][arch]:
        assert r["serve"]["weight_bytes"] == want
    assert want <= total - experts // 2
    calls = runs["ranks"][arch][0]["serve"]["calls"]
    assert calls and all(n % cfg.num_layers == 0 for n in calls.values())


# --------------------------------------------------------------- training
def _check_step(got, want):
    m, w = got["metrics"], want["metrics"]
    for k in ("loss", "grad_norm", "aux"):
        assert abs(m[k] - w[k]) <= RTOL * abs(w[k]), (k, m[k], w[k])
    for path, wp in _leaves(want["params"]):
        np.testing.assert_allclose(_get(got["params"], path), wp,
                                   rtol=0, atol=PARAM_ATOL, err_msg=path)
    for path, wm in want["masks"].items():
        np.testing.assert_array_equal(got["masks"][path], wm, err_msg=path)


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_model2_matches_reference(runs, arch, sp):
    want = runs["ref"][arch]["mb1"]
    for r in runs["ranks"][arch]:
        _check_step(r["m2"][sp], want)


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_data2_model2_matches_reference(runs, arch, sp):
    """Against the reference's step over two microbatches, each data
    rank's rows: routing and capacity per data rank, the aux averaged."""
    want = runs["ref"][arch]["mb2"]
    for r in runs["all"]:
        _check_step(r["d2m2"][arch][sp], want)
    # the global batch routed whole gives another step
    whole = runs["ref"][arch]["mb1"]["metrics"]["loss"]
    assert abs(want["metrics"]["loss"] - whole) > RTOL * abs(whole)


def _grad_errs(got, want):
    return {p: float(np.abs(_get(got, p) - w).max()
                     / max(np.abs(w).max(), 1e-30))
            for p, w in _leaves(want)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(runs, arch):
    want = runs["ref"][arch]["grads"]
    for r in runs["ranks"][arch]:
        errs = _grad_errs(r["m2"][True]["grads"], want)
        assert max(errs.values()) <= GRAD_REL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_aux_fault_misses(runs, arch):
    """The aux gradient counted on both ranks: the router's gradient
    misses the bar."""
    want = runs["ref"][arch]["grads"]
    for r in runs["ranks"][arch]:
        errs = _grad_errs(r["planted_aux"]["grads"], want)
        assert errs["layers/mlp/router"] > 100 * GRAD_REL, errs


# ---------------------------------------------------------- in-process
def _full_pack(arch):
    cfg = port_cfg(_jcfg(arch))
    from repro_torch.models import registry
    return cfg, interop.to_torch(
        _packed(cfg, registry.init_params(cfg, 0, device="cpu")),
        device="cpu")


def _reference_layout_shard(p, path, mesh, lead_axes):
    """The reference's ``abstract_packed_params`` layout for an expert
    pack, applied one dim at a time: the experts dim and the ``nb`` (or
    padded ``nnz``) dim both split over the model axis."""
    tp = mesh.shape[-1]
    r = mesh.coords["model"]
    kind, nnz = texport._packed_layout(path, p.nb, p.nnz, tp)
    if kind == "nnz":
        from repro_torch.core import packing
        p = packing.pad_nnz(p, nnz)
    e = p.idx.shape[1] // tp
    dim = {"nb": 2, "nnz": 3}[kind]
    n = p.idx.shape[dim] // tp
    cut = lambda t: t.narrow(1, r * e, e).narrow(dim, r * n, n)  # noqa
    return PackedBCSC(cut(p.blocks).contiguous(), cut(p.idx).contiguous(),
                      p.kb, p.joint)


def _expert_slices_hold(cfg, full, tp, shard_fn):
    """Whether every rank's expert packs are the bitwise E/tp slice of
    the full packs, whole visit lists, not partial."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.models import registry
    axes = registry.axes_tree(cfg)
    e = cfg.num_experts // tp
    for r in range(tp):
        mesh = Mesh(("data", "model"), (1, tp), r)
        for leaf in ("w_gate", "w_up", "w_down"):
            path = "layers/mlp/" + leaf
            p = sm.get_path(full, path)
            got = shard_fn(p, path, mesh, sm.get_path(axes, path))
            if got.partial or got.idx.shape != p.idx[:, :e].shape:
                return False
            if not (torch.equal(got.blocks, p.blocks[:, r * e:(r + 1) * e])
                    and torch.equal(got.idx, p.idx[:, r * e:(r + 1) * e])):
                return False
    return True


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_pack_shard_is_the_expert_slice(arch, tp):
    """``shard_pack`` cuts an expert pack on its experts dim alone:
    bitwise the E/tp slice, no padding, not partial; the reference's
    layout (experts and nb/nnz both split) is not; the shared experts
    stay whole."""
    cfg, full = _full_pack(arch)
    assert _expert_slices_hold(cfg, full, tp, texport.shard_pack)
    assert not _expert_slices_hold(cfg, full, tp, _reference_layout_shard)
    local = texport.shard_params(cfg, full, Mesh(("data", "model"),
                                                 (1, tp), 1))
    for k, v in full["layers"]["mlp"].items():
        if k.startswith("ws_") or k == "router":
            got = local["layers"]["mlp"][k]
            if isinstance(v, PackedBCSC):
                assert torch.equal(got.blocks, v.blocks) and not got.partial
            else:
                assert torch.equal(got, v)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_split_experts_only(arch):
    """Params, train state and masks: expert stacks split on the experts
    dim alone, the router and shared experts replicated; abstract packs
    the same; a rank's bytes are half the experts plus its share of the
    rest."""
    cfg = port_cfg(_jcfg(arch))
    mesh = Mesh(("data", "model"), (2, 2), 0)
    from repro_torch.models import registry
    ps = sharding.param_specs_tree(registry.param_specs(cfg), mesh)
    ts = sharding.train_specs(cfg, mesh)
    _, aspecs = texport.abstract_packed_params(cfg, 0.8, mesh)
    mlp = ps["layers"]["mlp"]
    for leaf in ("w_gate", "w_up", "w_down"):
        assert mlp[leaf] == (None, "model", None, None)
        assert ts["params"]["layers"]["mlp"][leaf] == mlp[leaf]
        assert ts["masks"]["layers/mlp/" + leaf] == mlp[leaf]
        assert aspecs["layers"]["mlp"][leaf].blocks == (None, "model") + (
            None,) * 4
    for leaf in ("router", "ws_gate", "ws_up", "ws_down"):
        if leaf in mlp:
            assert not sharding.model_sharded(mlp[leaf])
            assert not sharding.model_sharded(
                ts["params"]["layers"]["mlp"][leaf])
            if leaf != "router":
                assert not sharding.model_sharded(
                    ts["masks"]["layers/mlp/" + leaf])
                assert not sharding.model_sharded(
                    aspecs["layers"]["mlp"][leaf].blocks)
    st = sharding.state_shardings(cfg, mesh)
    state = registry.init_params(cfg, 0, device="cpu")
    local = sharding.shard_tree(state, st.params)
    ex = sum(sharding.count_bytes(state["layers"]["mlp"][k])
             for k in ("w_gate", "w_up", "w_down"))
    assert sharding.count_bytes(local["layers"]["mlp"]) == (
        sharding.count_bytes(state["layers"]["mlp"]) - ex // 2)


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_partial_flags_name_router_and_shared_experts(arch, seq):
    cfg = port_cfg(_jcfg(arch))
    flags = dict(_leaves(sharding.partial_flags(cfg, seq)))
    want = {"layers/mlp/router"}
    if seq:
        want |= {"layers/ln_attn_scale", "layers/ln_mlp_scale",
                 "ln_f_scale"}
        if cfg.num_shared_experts:
            want |= {"layers/mlp/ws_gate", "layers/mlp/ws_up",
                     "layers/mlp/ws_down"}
    assert {p for p, f in flags.items() if f} == want


def test_refusals_and_expert_range():
    """MoE admitted where its experts split; the other families admitted
    (the recurrent ones where their heads split, refused naming the
    roadmap where they do not); each rank's expert range."""
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import GPT2_SMALL_SMOKE
    from repro_torch.distributed.context import check_serving, \
        check_training
    d2 = DistContext(Mesh(("data", "model"), (1, 2), 1))
    d4 = DistContext(Mesh(("data", "model"), (1, 4), 3))
    moe = get_config("deepseek-moe-16b", smoke=True)
    check_training(moe, d2)
    check_serving(moe, d4)
    assert d2.expert_range(8) == (4, 4) and d4.expert_range(64) == (48, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
        check_training(dataclasses.replace(moe, num_experts=6), d4)
    # the launcher serves under dist= through the engine, not the front door
    import repro_torch.launch.serve as launcher
    args = launcher.build_parser().parse_args(
        ["--arch", "deepseek-moe-16b", "--smoke", "--frontdoor"])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
        launcher._serve(moe, {}, args, "cpu", dist=d2)
    # the recurrent families where their heads split, refused where
    # they do not (zamba's 4 SSM heads over 3)
    d3 = DistContext(Mesh(("data", "model"), (1, 3), 1))
    zamba = get_config("zamba2-1.2b", smoke=True)
    for check in (check_training, check_serving):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 4"):
            check(zamba, d3)
    # the other families run under dist= too
    for cfg in (GPT2_SMALL_SMOKE, get_config("whisper-large-v3", smoke=True),
                get_config("internvl2-2b", smoke=True),
                get_config("rwkv6-3b", smoke=True), zamba):
        for check in (check_training, check_serving):
            check(cfg, d2)
