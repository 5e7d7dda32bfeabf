"""``dist=`` on the recurrent families (rwkv6, ``ssm``; zamba2,
``hybrid``) on the CPU: gloo ranks against the reference's single-device
functions.

One scenario of 4 ranks, started once (``_torch_dist_rank.py``,
``ssm_scenario``). The smoke configs of rwkv6-3b (48 padded heads of 16,
all of them drawn live, so that both ranks' heads compute) and
zamba2-1.2b (4 SSM heads, one application of the shared block), f32,
each on its own (data 1, model 2) pair of ranks, then both on all four
as (data 2, model 2). The weights are the port's seeded init (true
fan-in) with the leaves it sets to constants drawn
(``test_torch_rwkv6.draw_leaves``); the train state is the one-shot
masks at 0.5 with zero moments; the served tree is the port's f32 pack
at s = 0.7.

Held to ROADMAP's parity bar: the training forward (``registry.forward``,
``sp`` off and on) within 1e-5 of the logits' magnitude; every gradient
within 1e-5 of its magnitude plus ten times the port's own gradient
change under a 1e-7 relative perturbation of the weights (the random
rwkv6 smoke model is ill-conditioned, ``test_torch_ssm_serving``); one
``make_train_step`` on each mesh, ``sp`` on and off (loss and gradient
norm to 1e-5 relative, params to 5e-5, masks bitwise); the decode step
(``prefill_with_decode`` into an f32 cache: the prompts' last logits);
``serve_loop.generate``'s greedy streams (near-ties below 1e-5 accepted)
and its sampled draws (equal to the port's single device), at (data 1,
model 2) and with the rows split over the data axis at (data 2, model
2); the ranks' weight bytes; and a zamba train state saved from (data 2,
model 2) restored bitwise onto (data 1, model 4), onto (data 2, model 2)
and onto one device. The zamba cut (``sharding.Cut``), its gradient norm
and the partial-gradient flags run in-process.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
import _torch_dist_tp as tp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import serve_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from test_torch_dist_serving import _reference_tree  # noqa: E402
from test_torch_engine import _assert_same_or_near_tie  # noqa: E402
from test_torch_rwkv6 import _close, draw_leaves, ref_decode  # noqa: E402
from test_torch_ssm_serving import _ref_margin  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

ARCHS = {"rwkv6": "rwkv6-3b", "zamba": "zamba2-1.2b"}
NAMES = tuple(ARCHS)
NEW = 5


def _weights(jcfg, seed):
    """(reference params, numpy params): the port's seeded init (true
    fan-in) with the constant leaves drawn, and rwkv6's padded heads
    drawn like the live ones, so both ranks' heads compute."""
    cfg = port_cfg(jcfg)
    npt = draw_leaves(interop.to_numpy(treg.init_params(cfg, seed, "cpu")),
                      seed + 100)
    if cfg.family == "ssm":
        t, h = npt["layers"]["tmix"], cfg.num_heads
        rng = np.random.default_rng(seed + 200)
        for k in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            a = t[k] if k != "w_o" else t[k].swapaxes(-3, -2)
            pad = a[..., h:, :]
            pad[...] = rng.standard_normal(pad.shape) * a[..., :h, :].std()
    return jax.tree_util.tree_map(jnp.asarray, npt), npt


def _model(jcfg, seed):
    cfg = port_cfg(jcfg)
    jp, npt = _weights(jcfg, seed)
    js, host = tp._states(jcfg, jp, npt)
    rng = np.random.default_rng(seed + 1)
    serve = dict(cfg=cfg, params=tp.packed(cfg, npt), new=NEW,
                 equal=rng.integers(1, jcfg.vocab_size, (4, 6))
                 .astype(np.int32))
    m = dict(cfg=cfg, state=host, serve=serve,
             fwd=(rng.integers(0, jcfg.vocab_size, (2, tp.S))
                  .astype(np.int32), {}),
             batch=tp._batch(jcfg, seed + 2))
    return m, dict(jcfg=jcfg, jp=jp, js=js,
                   jtree=_reference_tree(serve["params"]))


def _noise(cfg, host, batch):
    """How far the port's own one device moves under a 1e-7 relative
    perturbation of the weights: per leaf path, its gradient ("grads")
    and its train-step update ("update"), and the gradient norm
    ("grad_norm")."""
    _, topt = tp.opts()
    st = interop.train_state(host, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    noisy = dataclasses.replace(st, params=adamw.tree_map(
        lambda a: a * (1 + 1e-7 * torch.randn(a.shape, generator=gen)),
        st.params))
    g, upd = [], []
    for s in (st, noisy):
        g.append(ranks._np(tstep.loss_and_grads(cfg, s, b)[2]))
        after = tstep.make_train_step(cfg, topt)(s, b)[0]
        upd.append(ranks._np(adamw.tree_map(torch.sub, after.params,
                                            s.params)))
    return {"grads": {p: float(np.abs(tp.get(g[1], p) - v).max())
                      for p, v in tp.leaves(g[0])},
            "update": {p: float(np.abs(tp.get(upd[1], p) - v).max())
                       for p, v in tp.leaves(upd[0])},
            "grad_norm": abs(_norm(g[1]) - _norm(g[0]))}


def _norm(tree) -> float:
    return float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                             for _, x in tp.leaves(tree))))


def _prefill_f32(jcfg, jtree, prompts):
    """The reference's decode step over the prompts into an f32 cache:
    the last logits."""
    step = ref_decode(jcfg)
    cache = jreg.init_cache(jcfg, prompts.shape[0], prompts.shape[1],
                            dtype=jnp.float32)
    for i in range(prompts.shape[1]):
        logits, cache = step(jtree, cache, jnp.asarray(prompts[:, i:i + 1]),
                             jnp.int32(i))
    return np.asarray(logits[:, -1])


def _answers(m, r):
    jopt, _ = tp.opts()
    jcfg = r["jcfg"]
    r["logits"] = np.asarray(jreg.forward(jcfg, r["jp"],
                                          jnp.asarray(m["fwd"][0]))[0])
    r["step"] = tp._step(jcfg, jopt, r["js"], m["batch"])
    r["grads"] = tp._grads(jcfg, r["js"], m["batch"])
    r["noise"] = _noise(m["cfg"], m["state"], m["batch"])
    sv = m["serve"]
    r["loop"] = np.asarray(jloop.generate(jcfg, r["jtree"], sv["equal"],
                                          max_new_tokens=NEW)[0])
    r["prefill"] = _prefill_f32(jcfg, r["jtree"], sv["equal"])
    r["sampled"] = _sampled(m["cfg"], sv)


def _sampled(cfg, sv):
    """The port's single-device sampled draws (generator seed 7)."""
    from repro_torch.serving import serve_loop
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    return serve_loop.generate(
        cfg, interop.to_torch(sv["params"], device="cpu"), sv["equal"],
        max_new_tokens=NEW, temperature=0.8, generator=gen,
        device="cpu")[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, topt = tp.opts()
    models, ref = {}, {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        models[name], ref[name] = _model(
            jconfigs.get_config(arch, smoke=True), 50 + 10 * i)
    d = str(tmp_path_factory.mktemp("ssm"))
    procs = ranks.start(d, 4, train=dict(
        pairs=NAMES, models=models, opt=topt, mesh=(2, 2),
        ckpt_dir=str(tmp_path_factory.mktemp("ckpt"))), scenario="ssm")
    with concurrent.futures.ThreadPoolExecutor(len(ref)) as pool:
        for f in [pool.submit(_answers, models[n], r)
                  for n, r in ref.items()]:
            f.result()
    got = ranks.collect(d, procs)
    return {"ref": ref, "models": models, "all": got,
            "ranks": {n: [g for g in got if g["name"] == n] for n in ref}}


@pytest.mark.parametrize("sp", [False, True], ids=["replicated", "sp"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name, sp):
    for r in runs["ranks"][name]:
        _close(r["logits"][sp], runs["ref"][name]["logits"])


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference(runs, name):
    """Every leaf's gradient (sp on, gathered) within 1e-5 of its
    magnitude plus ten times the port's own change under perturbed
    weights."""
    ref = runs["ref"][name]
    for r in runs["ranks"][name]:
        got = r["m2"][True]["grads"]
        for path, g in tp.leaves(ref["grads"]):
            g = np.asarray(g, np.float64)
            err = float(np.abs(tp.get(got, path) - g).max())
            tol = (1e-5 * max(1.0, float(np.abs(g).max()))
                   + 10 * ref["noise"]["grads"][path])
            assert err <= tol, (path, err, tol)


def _check_step(got, ref):
    """``_torch_dist_tp.check_step``'s bar (loss to 1e-5 relative, masks
    bitwise), with the gradient norm within 1e-5 of it and each param
    within 5e-5, each plus ten times the port's own change there under
    perturbed weights (``_noise``). rwkv6's smoke model moves its norm
    by ~1e-4 relative and flips Adam's update of near-zero gradients
    under a 1e-7 perturbation, so one device's port and the reference
    differ by as much (1.5e-4 in the norm, 2e-4 in ``w_o``); zamba's
    changes are far below the bar."""
    want, noise = ref["step"], ref["noise"]
    m, w = got["metrics"], want["metrics"]
    assert abs(m["loss"] - w["loss"]) <= tp.RTOL * abs(w["loss"])
    tol = tp.RTOL * abs(w["grad_norm"]) + 10 * noise["grad_norm"]
    assert abs(m["grad_norm"] - w["grad_norm"]) <= tol, (m, w, tol)
    for path, wp in tp.leaves(want["params"]):
        np.testing.assert_allclose(
            tp.get(got["params"], path), wp, rtol=0,
            atol=tp.PARAM_ATOL + 10 * noise["update"][path], err_msg=path)
    for path, wm in want["masks"].items():
        np.testing.assert_array_equal(got["masks"][path], wm, err_msg=path)


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_model2_matches_reference(runs, name, sp):
    for r in runs["ranks"][name]:
        _check_step(r["m2"][sp], runs["ref"][name])


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_data2_model2_matches_reference(runs, name, sp):
    for r in runs["all"]:
        _check_step(r["d2m2"][name][sp], runs["ref"][name])


@pytest.mark.parametrize("mesh", ["m2", "d2m2"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(runs, name, mesh):
    """The prompts' last logits after the decode step over them, into an
    f32 cache, on every rank (the rows split over the data axis at
    (data 2, model 2) and gathered)."""
    want = runs["ref"][name]["prefill"]
    got = [r["serve"] if mesh == "m2" else r["serve22"][name]
           for r in (runs["ranks"][name] if mesh == "m2" else runs["all"])]
    for g in got:
        _close(g["prefill_logits"], want)


@pytest.mark.parametrize("mesh", ["m2", "d2m2"])
@pytest.mark.parametrize("name", NAMES)
def test_serve_loop_matches_reference(runs, name, mesh):
    """Greedy streams equal the reference's but for near-ties, equal on
    every rank; sampled draws equal the port's single device's."""
    r = runs["ref"][name]
    plen = runs["models"][name]["serve"]["equal"].shape[1]
    got = [x["serve"] if mesh == "m2" else x["serve22"][name]
           for x in (runs["ranks"][name] if mesh == "m2" else runs["all"])]
    for g in got:
        for lane, w in zip(g["loop"], r["loop"]):
            _assert_same_or_near_tie(
                lane, w, plen, lambda s: _ref_margin(r["jcfg"], r["jtree"],
                                                     s))
        np.testing.assert_array_equal(g["loop"], got[0]["loop"])
        np.testing.assert_array_equal(g["sampled"], r["sampled"])


@pytest.mark.parametrize("name", NAMES)
def test_rank_bytes_are_the_shard(runs, name):
    """A rank's serving bytes are ``shard_params``' on the full pack, and
    less than the whole tree's."""
    cfg = runs["models"][name]["cfg"]
    full = interop.to_torch(runs["models"][name]["serve"]["params"],
                            device="cpu")
    total = texport.memory_report(cfg, full)["bytes"]
    for r in runs["ranks"][name]:
        local = texport.shard_params(cfg, full, Mesh(
            ("data", "model"), (1, 2), r["model_rank"]))
        want = texport.memory_report(cfg, local)["bytes"]
        assert r["serve"]["weight_bytes"] == want < total


@pytest.mark.parametrize("onto", ["m4", "d2m2", "one"])
def test_zamba_state_restores_across_meshes(runs, onto):
    """Saved from (data 2, model 2), restored bitwise as the shard of
    the logical state that (data 1, model 4), (data 2, model 2) or one
    device holds; the Mamba leaves are split at model 4."""
    for r in runs["all"]:
        assert all(r["elastic"][onto])
        cut = r["elastic"]["cut"]
        assert all(cut[k] for k in ("in_proj", "conv_w", "conv_b", "a_log",
                                    "out_proj"))
        assert not cut["ln_scale"]


# ---------------------------------------------------------- in-process
def _zamba():
    return port_cfg(jconfigs.get_config("zamba2-1.2b", smoke=True))


@pytest.mark.parametrize("tps", [2, 4])
def test_zamba_cut_is_by_meaning(tps):
    """Each rank's ``in_proj`` is ``[z_r | x_r | B C | dt_r]`` and its
    conv ``[x_r | B C]``, by heads, B and C whole; ``shard`` of the
    full leaf gives it, ``shard_params`` agrees, and the blocks of every
    rank put back together (``Cut`` segment by segment) give the leaf
    bitwise."""
    cfg = _zamba()
    di, nh, st = cfg.ssm_expand * cfg.d_model, cfg.ssm_heads, cfg.ssm_state
    full = treg.init_params(cfg, 3, "cpu")
    specs = sharding.param_specs_tree(treg.param_specs(cfg),
                                      Mesh(("data", "model"), (1, tps), 0))
    for name in ("in_proj", "conv_w", "conv_b"):
        spec = specs["layers"][name]
        cut = spec[-1]
        assert isinstance(cut, sharding.Cut)
        w = full["layers"][name]
        parts = []
        for r in range(tps):
            mesh = Mesh(("data", "model"), (1, tps), r)
            local = sharding.shard(w, spec, mesh)
            assert torch.equal(
                local, texport.shard_params(cfg, full, mesh)["layers"][name])
            a, b = r * di // tps, (r + 1) * di // tps
            want = [w[..., a:b]]
            if name == "in_proj":
                want = [w[..., a:b], w[..., di + a:di + b],
                        w[..., 2 * di:2 * di + 2 * st],
                        w[..., -nh:][..., r * nh // tps:(r + 1) * nh // tps]]
            else:
                want += [w[..., di:]]
            assert torch.equal(local, torch.cat(want, dim=-1))
            parts.append(local.split(cut.local(tps), dim=-1))
        back = []
        for j, (_, split) in enumerate(cut.parts):
            back.append(torch.cat([p[j] for p in parts], dim=-1) if split
                        else parts[0][j])
        assert torch.equal(torch.cat(back, dim=-1), w)


def test_cut_norm_counts_whole_segments_once():
    """The gradient norm's square sums of a cut leaf: the split segments'
    summed over the ranks, the whole ones counted once, give the full
    leaf's."""
    cfg = _zamba()
    w = treg.init_params(cfg, 4, "cpu")["layers"]["in_proj"]
    mesh = Mesh(("data", "model"), (1, 2), 0)
    shd = sharding.state_shardings(cfg, mesh).params["layers"]["in_proj"]
    flag = sharding.shard_flags({"w": shd})["w"]
    assert isinstance(flag, sharding.CutFlag)
    split = whole = 0.0
    for r in range(2):
        s, wh = flag.square_sums(sharding.shard(
            w, shd.spec, Mesh(("data", "model"), (1, 2), r)))
        split, whole = split + float(s), float(wh)
    np.testing.assert_allclose(split + whole, float((w.double() ** 2).sum()),
                               rtol=1e-6)


@pytest.mark.parametrize("seq", [False, True])
def test_partial_flags_name_the_whole_leaves(seq):
    """rwkv6: the time mix's ``mu_*`` and ``lora_a`` always, and under
    ``seq`` the norms, the channel mix's ``mu_*`` and ``w_recept``;
    zamba: only the norms under ``seq`` (its B/C weights are summed by
    ``copy_to_model`` in the forward)."""
    cfg = port_cfg(jconfigs.get_config("rwkv6-3b", smoke=True))
    flags = {p for p, f in tp.leaves(sharding.partial_flags(cfg, seq)) if f}
    want = {f"layers/tmix/{k}" for k in ("mu_r", "mu_k", "mu_v", "mu_g",
                                         "mu_w", "lora_a")}
    if seq:
        want |= {"layers/ln1_scale", "layers/ln1_bias", "layers/ln2_scale",
                 "layers/ln2_bias", "layers/mlp/mu_k", "layers/mlp/mu_r",
                 "layers/mlp/w_recept", "ln_f_scale", "ln_f_bias"}
    assert flags == want
    zflags = {p for p, f in tp.leaves(sharding.partial_flags(_zamba(), seq))
              if f}
    assert zflags == ({"layers/ln_scale", "shared/ln_attn_scale",
                       "shared/ln_mlp_scale", "ln_f_scale"} if seq else set())


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_cache_holds_the_rank_heads_and_rows(arch):
    """``registry.abstract_cache(dist=)``: the rank's heads (rwkv6's 24
    of 48, zamba's 2 of 4 SSM heads, its x channels with the whole B/C
    ones, 1 of 2 kv heads) and its data group's rows (4 of 8; 3 whole)."""
    cfg = port_cfg(jconfigs.get_config(arch, smoke=True))
    d = DistContext(Mesh(("data", "model"), (2, 2), 3))
    one = treg.abstract_cache(cfg, 8, 16)
    got = treg.abstract_cache(cfg, 8, 16, dist=d)
    odd = treg.abstract_cache(cfg, 3, 16, dist=d)
    for k, a in one.items():
        shape = list(a.shape)
        shape[1] //= 2
        if k in ("state", "ssm", "k", "v"):
            shape[2 if k != "k" and k != "v" else 3] //= 2
        if k == "conv":
            st = cfg.ssm_state
            shape[-1] = (shape[-1] - 2 * st) // 2 + 2 * st
        assert tuple(got[k].shape) == tuple(shape), k
        assert odd[k].shape[1] == 3
