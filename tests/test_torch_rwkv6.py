"""The port's rwkv6 (``repro_torch/models/rwkv6.py``, the ``ssm`` family)
against the reference on the smoke config (48 heads of 16, 4 of them
live, chunk 16), on the same weights: ``time_mix`` (chunked, with a
state and a shifted-in token, and the decode step), ``channel_mix``
(dense with masks, and packed through the plain ``bspmm``), the training
``forward`` with masks, and 16 ``decode_step``s from a cache carried
across from the reference; f32 outputs within 1e-5 of their magnitude.
The seeded init zeroes ``mu_*``, ``u`` and ``w0``, which hides the token
shift and the bonus, so those leaves (and the layer norms) are drawn
from a numpy seed first; one case pushes ``w0`` past the clip at 4, so
that every per-step decay (-e^4) lies below the chunk's floor. Also: the
export's packed ``idx``/``blocks`` bitwise, the padded heads zero at
init with each 3-D weight's true fan-in, and the parameter counts.

``draw_leaves`` and ``one_shot`` serve the zamba and serving tests too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_transformer import port_cfg  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.core.prune_grow import initial_mask  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402

ARCH = "rwkv6-3b"

# leaves the seeded init sets to constants, drawn here: name -> (kind,
# scale, offset); "u" is uniform in [0, 1) (token-shift mixes)
DRAWN = {
    "mu_r": ("u", 1, 0), "mu_k": ("u", 1, 0), "mu_v": ("u", 1, 0),
    "mu_g": ("u", 1, 0), "mu_w": ("u", 1, 0),
    "u": ("n", 0.5, 0), "w0": ("n", 0.5, -0.5),
    "ln_x_scale": ("n", 0.2, 1), "ln1_scale": ("n", 0.1, 1),
    "ln2_scale": ("n", 0.1, 1), "ln1_bias": ("n", 0.1, 0),
    "ln2_bias": ("n", 0.1, 0),
    # zamba's
    "a_log": ("n", 0.5, 0), "dt_bias": ("n", 0.5, 0),
    "d_skip": ("n", 0.2, 1), "conv_b": ("n", 0.1, 0),
    "norm_scale": ("n", 0.1, 0), "ln_scale": ("n", 0.1, 0),
}


def draw_leaves(tree, seed, w0_offset=None):
    """A numpy copy of ``tree`` with every ``DRAWN`` leaf drawn from
    ``seed`` (``w0`` shifted to ``w0_offset`` when given)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in DRAWN:
                kind, scale, off = DRAWN[k]
                if k == "w0" and w0_offset is not None:
                    off = w0_offset
                x = (rng.random(v.shape) if kind == "u"
                     else rng.standard_normal(v.shape))
                out[k] = (x * scale + off).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def one_shot(jcfg, params, s=0.8):
    """The reference launcher's one-shot magnitude masks at ``s``
    (balanced, vmapped over any leading layer axis)."""
    spec = dataclasses.replace(jcfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in jreg.sparse_paths(jcfg):
        w = jsm.get_path(params, path)
        bi, bo = jsm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        fn = lambda wi, ps=pspec: initial_mask(ps, wi)  # noqa: E731
        for _ in range(w.ndim - 2):
            fn = jax.vmap(fn)
        masks[path] = fn(w)
    return masks


def model(jcfg, seed=0, w0_offset=None):
    """(reference params, port params) sharing drawn weights."""
    raw = jax.device_get(jreg.init_params(jcfg, jax.random.PRNGKey(seed)))
    npt = draw_leaves(raw, seed + 100, w0_offset)
    return (jax.tree_util.tree_map(jnp.asarray, npt),
            interop.to_torch(npt, device="cpu"))


def ref_decode(jcfg):
    """The reference's ``registry.decode_step`` for ``jcfg``, jitted:
    op-by-op it costs about a second a step on the CPU, its compile less
    than one step."""
    return jax.jit(lambda p, c, x, pos, **kw: jreg.decode_step(
        jcfg, p, c, x, pos, **kw))


def _close(got, want, frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = frac * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs err {err} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("w0", [None, 4.5], ids=["drawn", "floor_binds"])
@pytest.mark.parametrize("s", [16, 32])
def test_time_mix_chunked(cfgs, s, w0):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 1, w0)
    h, dk, _ = trw._heads(tcfg)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((2, h, dk, dk)).astype(np.float32)
    xl = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jo, (js, jx) = jrw.time_mix(jcfg, _layer(jp["layers"], 1)["tmix"],
                                jnp.asarray(x), state=jnp.asarray(st),
                                x_last=jnp.asarray(xl))
    to, (ts, tx) = trw.time_mix(tcfg, _layer(tp["layers"], 1)["tmix"],
                                _t(x), state=_t(st), x_last=_t(xl))
    _close(to.numpy(), jo)
    _close(ts.numpy(), js)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("w0", [None, 4.5], ids=["drawn", "floor_binds"])
def test_time_mix_decode(cfgs, w0):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 2, w0)
    h, dk, _ = trw._heads(tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((3, h, dk, dk)).astype(np.float32)
    xl = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
    jo, (js, _) = jrw.time_mix(jcfg, _layer(jp["layers"], 0)["tmix"],
                               jnp.asarray(x), state=jnp.asarray(st),
                               x_last=jnp.asarray(xl), decode=True)
    to, (ts, _) = trw.time_mix(tcfg, _layer(tp["layers"], 0)["tmix"],
                               _t(x), state=_t(st), x_last=_t(xl),
                               decode=True)
    _close(to.numpy(), jo)
    _close(ts.numpy(), js)


def test_channel_mix_dense_with_masks(cfgs):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 3)
    m = one_shot(jcfg, jp)
    lm = {k.split("/")[-1]: v[1] for k, v in m.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    xl = np.random.default_rng(5).standard_normal(
        (2, jcfg.d_model)).astype(np.float32)
    jy, jx = jrw.channel_mix(jcfg, _layer(jp["layers"], 1)["mlp"],
                             jnp.asarray(x), masks=lm,
                             x_last=jnp.asarray(xl))
    ty, tx = trw.channel_mix(tcfg, _layer(tp["layers"], 1)["mlp"], _t(x),
                             masks={k: _t(v) for k, v in lm.items()},
                             x_last=_t(xl))
    _close(ty.numpy(), jy)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_channel_mix_packed_through_the_plain_bspmm(cfgs):
    """Layer 0's packed channel-mix (bf16 blocks): ``bspmm`` on the CPU
    runs its plain version, the reference's packed ``mlp2`` its XLA
    twin."""
    jcfg, tcfg = cfgs
    jp, _ = model(jcfg, 4)
    jpk = jexport.pack_params(jcfg, jp, one_shot(jcfg, jp))
    tpk = interop.to_torch(jax.device_get(jpk), device="cpu")
    x = np.random.default_rng(6).standard_normal(
        (3, 4, jcfg.d_model)).astype(np.float32)
    jy, _ = jrw.channel_mix(jcfg, _layer(jpk["layers"], 0)["mlp"],
                            jnp.asarray(x))
    from repro_torch.models.transformer import _layer_view
    ty, _ = trw.channel_mix(tcfg, _layer_view(tpk["layers"], 0)["mlp"],
                            _t(x))
    _close(ty.numpy(), jy)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masks"])
def test_forward(cfgs, masked):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 5)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jm = one_shot(jcfg, jp) if masked else None
    tm = interop.to_torch(jax.device_get(jm), device="cpu") if masked \
        else None
    jl, ja = jreg.forward(jcfg, jp, jnp.asarray(toks), masks=jm)
    tl, ta = treg.forward(tcfg, tp, _t(toks), masks=tm)
    assert float(ta) == float(ja) == 0.0
    _close(tl.numpy(), jl)


@pytest.mark.parametrize("w0", [None, 4.5], ids=["drawn", "floor_binds"])
def test_decode_steps_from_a_carried_cache(cfgs, w0):
    """Four reference steps seed an f32 cache, which crosses to the port
    (``interop``); then 16 steps on each side, logits every step and the
    final caches (crossed back) within tolerance."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 6, w0)
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jc = jreg.init_cache(jcfg, 2, 20, dtype=jnp.float32)
    jdecode = ref_decode(jcfg)
    for t in range(4):
        _, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    tc = interop.to_torch(jax.device_get(jc), device="cpu")
    for t in range(4, 20):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = treg.decode_step(tcfg, tp, tc, _t(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
    back = interop.to_numpy(tc)
    assert set(back) == {"state", "x_tmix", "x_cmix"}
    for k in back:
        _close(back[k], jc[k])


def test_init_cache_layout(cfgs):
    jcfg, tcfg = cfgs
    jc = jreg.init_cache(jcfg, 3, 8)
    tc = treg.init_cache(tcfg, 3, 8, device="cpu")
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)


def test_pack_params_bitwise(cfgs):
    """The port's export of the same f32 weights and masks: every leaf
    bitwise, the stacked packs' ``idx`` and ``blocks`` included (no
    gate/up pair, so nothing is joint)."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 7)
    jm = one_shot(jcfg, jp)
    tm = interop.to_torch(jax.device_get(jm), device="cpu")
    want = interop.to_torch(jax.device_get(
        jexport.pack_params(jcfg, jp, jm)), device="cpu")
    got = texport.pack_params(tcfg, tp, tm)
    flat_w, flat_g = interop.to_numpy(want), interop.to_numpy(got)
    for path in ("layers/mlp/w_in", "layers/mlp/w_out"):
        gw, gg = jsm.get_path(flat_w, path), jsm.get_path(flat_g, path)
        assert gg["kb"] == gw["kb"] and gg["joint"] is gw["joint"] is False
        np.testing.assert_array_equal(gg["idx"], gw["idx"])
        np.testing.assert_array_equal(gg["blocks"].view(np.int16),
                                      gw["blocks"].view(np.int16))
    for k in ("w0", "u", "lora_b"):
        a = flat_g["layers"]["tmix"][k]
        assert a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(
            a.view(np.int16), flat_w["layers"]["tmix"][k].view(np.int16))
    assert (texport.memory_report(tcfg, got)["bytes"]
            == jexport.memory_report(jcfg, jexport.pack_params(
                jcfg, jp, jm))["bytes"])


def test_padded_heads_zero_at_init_and_fan_in(cfgs):
    """48 heads of which ``num_heads`` live: the padded heads' r/k/v/g
    columns and ``w_o`` rows start at zero; every 3-D weight's spread
    follows its true fan-in (d, H*dk, the LoRA rank), named on the
    specs of the full config too."""
    _, tcfg = cfgs
    n = tcfg.num_heads
    h, dk, inner = trw._heads(tcfg)
    assert h == 48 > n
    p = treg.init_params(tcfg, 0, "cpu")["layers"]["tmix"]
    for name in ("w_r", "w_k", "w_v", "w_g"):
        assert not p[name][..., n:, :].any()
        std = float(p[name][..., :n, :].std())
        assert abs(std * tcfg.d_model ** 0.5 - 1) < 0.05, (name, std)
    assert not p["w_o"][:, n:].any()
    scale = 1 / (2 * tcfg.num_layers) ** 0.5
    std = float(p["w_o"][:, :n].std())
    assert abs(std / scale * inner ** 0.5 - 1) < 0.05
    std = float(p["lora_b"].std())
    assert abs(std * trw.LORA_RANK ** 0.5 - 1) < 0.05
    full = treg.param_specs(jconfigs.get_config(ARCH))["layers"]["tmix"]
    assert [full[k].fan_in for k in ("w_r", "w_k", "w_v", "w_g", "w_o",
                                     "lora_b")] == [2560] * 4 + [3072, 64]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_counts_match_reference(smoke):
    t = jconfigs.get_config(ARCH, smoke=smoke)
    assert treg.count_params(port_cfg(t)) == jreg.count_params(t)
    assert treg.sparse_paths(port_cfg(t)) == jreg.sparse_paths(t)
    np.testing.assert_array_equal(
        treg.dense_layer_flags(port_cfg(t)).numpy(),
        np.asarray(jreg.dense_layer_flags(t)))
