"""The port's zamba2 (``repro_torch/models/zamba.py``, the ``hybrid``
family) against the reference on the same weights, on the smoke config
(6 layers, one application of the shared block) and on a variant with 8
layers and ``attn_every`` 3 (three applications, at layers 0, 3 and 6,
the last span two layers long): ``_causal_conv`` with and without its
state, ``mamba_mixer`` (chunked prefill with initial states, and the
decode step), ``_shared_block`` (full attention, and decode over its KV
cache), the training ``forward`` with masks, and 16 ``decode_step``s
from a cache carried across from the reference; f32 within 1e-5 of the
output's magnitude (the whole-depth training forward within 3e-5). ``a_log``, ``dt_bias``, ``d_skip`` and the norms,
constants at init, are drawn from a numpy seed. Also the unstacked 2-D
shared GLU packed bitwise (split masks; joint when up takes gate's
mask), the parameter counts and the cache layout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_rwkv6 import _close, _layer, _t, model, one_shot  # noqa: E402
from test_torch_rwkv6 import ref_decode  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import zamba as jzb  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import zamba as tzb  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402

ARCH = "zamba2-1.2b"


def _cfg(variant):
    j = jconfigs.get_config(ARCH, smoke=True)
    if variant == "apps3":
        j = dataclasses.replace(j, num_layers=8, attn_every=3)
    return j


@pytest.fixture(scope="module", params=["smoke", "apps3"])
def cfgs(request):
    jcfg = _cfg(request.param)
    return jcfg, port_cfg(jcfg)


def test_applications(cfgs):
    jcfg, tcfg = cfgs
    assert tzb.n_shared_applications(tcfg) == jzb.n_shared_applications(
        jcfg) == (1 if jcfg.num_layers == 6 else 3)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state"])
def test_causal_conv(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jy, jt = jzb._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(st) if with_state else None)
    ty, tt = tzb._causal_conv(_t(x), _t(w), _t(b),
                              _t(st) if with_state else None)
    _close(ty.numpy(), jy)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("s", [1, 16, 32], ids=["decode", "S16", "S32"])
def test_mamba_mixer(cfgs, s):
    """Prefill (chunk 16: one or two chunks) from random SSM and conv
    states, and the one-token decode step."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 1)
    d_inner, nh, hd, ds = tzb._dims(tcfg)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    ss = rng.standard_normal((2, nh, ds, hd)).astype(np.float32)
    cs = rng.standard_normal((2, jcfg.conv_kernel - 1,
                              d_inner + 2 * ds)).astype(np.float32)
    dec = s == 1
    jy, (js, jc) = jzb.mamba_mixer(jcfg, _layer(jp["layers"], 2),
                                   jnp.asarray(x), ssm_state=jnp.asarray(ss),
                                   conv_state=jnp.asarray(cs), decode=dec)
    ty, (ts, tc) = tzb.mamba_mixer(tcfg, _layer(tp["layers"], 2), _t(x),
                                   ssm_state=_t(ss), conv_state=_t(cs),
                                   decode=dec)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)
    _close(tc.numpy(), jc)


def test_shared_block_full_and_decode(cfgs):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    jy, _ = jzb._shared_block(jcfg, jp["shared"], jnp.asarray(x),
                              jnp.asarray(pos), None)
    ty, _ = tzb._shared_block(tcfg, tp["shared"], _t(x), _t(pos), None)
    _close(ty.numpy(), jy)
    kv = treg.init_cache(tcfg, 2, 12, dtype=torch.float32, device="cpu")
    ck = rng.standard_normal(kv["k"].shape[1:]).astype(np.float32)
    cv = rng.standard_normal(kv["v"].shape[1:]).astype(np.float32)
    x1 = x[:, :1]
    jy, (jk, jv) = jzb._shared_block(jcfg, jp["shared"], jnp.asarray(x1),
                                     None, None, cache=(jnp.asarray(ck),
                                                        jnp.asarray(cv)),
                                     pos=jnp.int32(5))
    ty, (tk, tv) = tzb._shared_block(tcfg, tp["shared"], _t(x1), None, None,
                                     cache=(_t(ck), _t(cv)), pos=5)
    _close(ty.numpy(), jy)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masks"])
def test_forward(cfgs, masked):
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 3)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jm = one_shot(jcfg, jp) if masked else None
    tm = interop.to_torch(jax.device_get(jm), device="cpu") if masked \
        else None
    jl, _ = jreg.forward(jcfg, jp, jnp.asarray(toks), masks=jm)
    tl, ta = treg.forward(tcfg, tp, _t(toks), masks=tm)
    assert float(ta) == 0.0
    # the whole depth over 32 tokens (8 layers and three attention
    # applications in the variant): the two sides' f32 rounding adds up
    # to about 1e-5 of the logits' magnitude
    _close(tl.numpy(), jl, 3e-5)


def test_decode_steps_from_a_carried_cache(cfgs):
    """Three reference steps seed an f32 cache, which crosses to the port;
    then 16 steps on each side, logits every step and the final caches
    (crossed back) within tolerance."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 4)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    jc = jreg.init_cache(jcfg, 2, 19, dtype=jnp.float32)
    jdecode = ref_decode(jcfg)
    for t in range(3):
        _, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    tc = interop.to_torch(jax.device_get(jc), device="cpu")
    for t in range(3, 19):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = treg.decode_step(tcfg, tp, tc, _t(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
    back = interop.to_numpy(tc)
    assert set(back) == {"ssm", "conv", "k", "v"}
    for k in back:
        _close(back[k], jc[k])


def test_init_cache_layout(cfgs):
    """bf16 by default; the conv tail takes the compute dtype after the
    first step on both sides."""
    jcfg, tcfg = cfgs
    jc = jreg.init_cache(jcfg, 3, 8)
    tc = treg.init_cache(tcfg, 3, 8, device="cpu")
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)
    jp, tp = model(jcfg, 5)
    _, jc = jreg.decode_step(jcfg, jp, jc, jnp.zeros((3, 1), jnp.int32),
                             jnp.int32(0))
    _, tc = treg.decode_step(tcfg, tp, tc, torch.zeros((3, 1),
                                                       dtype=torch.int32), 0)
    for k in jc:
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k


@pytest.mark.parametrize("joint", [False, True], ids=["split", "joint"])
def test_shared_glu_packed_bitwise(cfgs, joint):
    """The one-shot prune and the pack of the unstacked (2-D) shared GLU:
    masks, ``idx`` and ``blocks`` bitwise, ``joint`` marked only when up
    takes gate's mask; then the packed model's logits against the
    reference's (the fused GLU and ``bspmm`` through their plain
    versions)."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 6)
    jm = one_shot(jcfg, jp)
    from repro_torch.launch.serve import one_shot_masks
    tm = one_shot_masks(tcfg, tp, 0.8)
    for path in jm:
        assert tm[path].dim() == 2
        np.testing.assert_array_equal(tm[path].numpy(), np.asarray(jm[path]))
    if joint:
        jm = dict(jm, **{"shared/mlp/w_up": jm["shared/mlp/w_gate"]})
        tm = dict(tm, **{"shared/mlp/w_up": tm["shared/mlp/w_gate"]})
    jpk = jexport.pack_params(jcfg, jp, jm)
    want = interop.to_numpy(interop.to_torch(jax.device_get(jpk),
                                             device="cpu"))
    tpk = texport.pack_params(tcfg, tp, tm)
    got = interop.to_numpy(tpk)
    for path in treg.sparse_paths(tcfg):
        gw, gg = jsm.get_path(want, path), jsm.get_path(got, path)
        assert gg["idx"].ndim == 2
        assert gg["kb"] == gw["kb"] and gg["joint"] == gw["joint"]
        assert gg["joint"] == (joint and not path.endswith("w_down"))
        np.testing.assert_array_equal(gg["idx"], gw["idx"])
        np.testing.assert_array_equal(gg["blocks"].view(np.int16),
                                      gw["blocks"].view(np.int16))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jreg.forward(jcfg, jpk, jnp.asarray(toks))
    tl, _ = treg.forward(tcfg, tpk, _t(toks))
    _close(tl.numpy(), jl)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_counts_match_reference(smoke):
    t = jconfigs.get_config(ARCH, smoke=smoke)
    assert treg.count_params(port_cfg(t)) == jreg.count_params(t)
    assert treg.sparse_paths(port_cfg(t)) == jreg.sparse_paths(t)
    assert treg.dense_layer_flags(port_cfg(t)) is None
    assert jreg.dense_layer_flags(t) is None


def test_dryrun_baseline_is_refused(cfgs, monkeypatch):
    jcfg, tcfg = cfgs
    _, tp = model(jcfg, 8)
    monkeypatch.setattr(tzb, "DRYRUN_BASELINE", True)
    with pytest.raises(NotImplementedError, match="DRYRUN_BASELINE"):
        treg.forward(tcfg, tp, torch.zeros((1, 16), dtype=torch.int32))
