"""The port's whisper (``repro_torch/models/whisper.py``, the ``audio``
family) against the reference on the same weights, on the smoke config
(4 query heads over 2 kv heads, padded to 32 query heads) and on an MHA
variant (4 heads over 4 kv heads, both padded to 32, as whisper-large-v3
pads 20 over 20): the spec tree, the padded heads zeroed by the port's
init in all three attention blocks, ``encode``, the training ``forward``
with frames, ``prefill_cross``'s ``ck``/``cv`` and 16 teacher-forced
``decode_step``s, each dense, with the one-shot masks, and packed (the
plain ``bspmm`` on the CPU); decode against the forward (the reference's
own check); ``loss_fn`` and every gradient with frames; and one train
step that refreshes the masks under the per-stack dense-layer flags,
masks bitwise. Weights cross from the port's seeded init through
``interop``, with the norms, the MLP biases and the padded heads drawn
from a numpy seed (the init sets the first two to constants and zeroes
the third), so every head is live and compared. f32 within 1e-5 of the
output's magnitude.

``model``, ``frames_for`` and ``exports`` serve the serving tests too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_rwkv6 import _close, _t, one_shot, ref_decode  # noqa: E402
from test_torch_train import _masks_equal, _opt  # noqa: E402
from test_torch_transformer import _flatten, port_cfg  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

ARCH = "whisper-large-v3"
B, S_ENC, S_DEC = 2, 24, 16


def smoke_cfg(variant="smoke"):
    j = jconfigs.get_config(ARCH, smoke=True)
    if variant == "mha":
        j = dataclasses.replace(j, num_kv_heads=j.num_heads)
    return j


def _drawn(tree, seed, num_heads):
    """A numpy copy of ``tree`` whose norm scales (1 + 0.1 n) and biases
    (0.1 n) are drawn from ``seed``, and whose padded heads (``wq``
    columns and ``wo`` rows past ``num_heads``) are drawn like the live
    ones."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.endswith("_scale"):
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k.endswith("_bias") or k in ("b_in", "b_out"):
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in ("wq", "wo"):
                a = np.array(v)
                live = a[..., :num_heads, :] if k == "wq" \
                    else a[:, :num_heads]
                pad = (a[..., num_heads:, :] if k == "wq"
                       else a[:, num_heads:])
                pad[...] = rng.standard_normal(pad.shape) * live.std()
                out[k] = a
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def model(jcfg, seed=0):
    """(reference params, port params) sharing the port's seeded init
    (true fan-in; the reference's head-axis scaling makes the GQA smoke
    model's residual stream grow to ~100 over four decoder layers, where
    f32 rounding alone moves the logits by 2e-5 of their magnitude) with
    drawn norms, biases and padded heads."""
    tcfg = port_cfg(jcfg)
    raw = interop.to_numpy(treg.init_params(tcfg, seed, "cpu"))
    npt = _drawn(raw, seed + 100, jcfg.num_heads)
    return (jax.tree_util.tree_map(jnp.asarray, npt),
            interop.to_torch(npt, device="cpu"))


def frames_for(jcfg, seed, b=B, s=S_ENC):
    """Seeded normal frame embeddings x 0.02 (B, S_enc, d_model)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, jcfg.d_model)) * 0.02).astype(
        np.float32)


def exports(jcfg, jp, kind):
    """(reference params, port params, reference masks, port masks) for
    ``kind``: the dense weights, the dense weights under the one-shot
    masks, or the packed export of the masked weights (bf16 leaves, so
    both sides hold the same values in f32 compute)."""
    if kind == "dense":
        return jp, interop.to_torch(jax.device_get(jp), device="cpu"), \
            None, None
    jm = one_shot(jcfg, jp)
    if kind == "masks":
        return (jp, interop.to_torch(jax.device_get(jp), device="cpu"), jm,
                interop.to_torch(jax.device_get(jm), device="cpu"))
    jpk = jexport.pack_params(jcfg, jp, jm)
    return jpk, interop.to_torch(jax.device_get(jpk), device="cpu"), \
        None, None


@pytest.fixture(scope="module", params=["smoke", "mha"])
def cfgs(request):
    jcfg = smoke_cfg(request.param)
    return jcfg, port_cfg(jcfg)


KINDS = ["dense", "masks", "packed"]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_specs_match_reference(smoke):
    jcfg = jconfigs.get_config(ARCH, smoke=smoke)
    tcfg = port_cfg(jcfg)
    flat = lambda t: {k: (v.shape, v.init, v.scale)  # noqa: E731
                      for k, v in _flatten(t)}
    assert flat(twh.param_specs(tcfg)) == flat(jwh.param_specs(jcfg))
    assert treg.count_params(tcfg) == jreg.count_params(jcfg)
    assert twh.MAX_POS == jwh.MAX_POS
    assert treg.sparse_paths(tcfg) == jreg.sparse_paths(jcfg)
    tf, jf = treg.dense_layer_flags(tcfg), jreg.dense_layer_flags(jcfg)
    assert set(tf) == set(jf) == {"encoder", "decoder"}
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))


def test_padded_heads_are_zero_at_init(cfgs):
    """The port's seeded init zeroes the ``wq`` columns and ``wo`` rows
    of every head ``pad_heads_to`` adds, in the encoder's attention and
    the decoder's self- and cross-attention; the live heads are not
    zero. Under MHA the kv heads are padded too."""
    jcfg, tcfg = cfgs
    h, kv = tattn.eff_heads(tcfg)
    assert h == 32 and kv == (32 if jcfg.num_kv_heads == jcfg.num_heads
                              else jcfg.num_kv_heads)
    p = treg.init_params(tcfg, 3, "cpu")
    for stack, block in (("encoder", "attn"), ("decoder", "attn"),
                         ("decoder", "cross")):
        a = p[stack][block]
        assert tuple(a["wk"].shape[-2:]) == (kv, tcfg.head_dim)
        n = tcfg.num_heads
        assert not a["wq"][..., n:, :].any() and not a["wo"][:, n:].any()
        assert a["wq"][..., :n, :].abs().min() > 0
        assert a["wo"][:, :n].abs().max() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_encode(cfgs, kind):
    jcfg, tcfg = cfgs
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 1)[0], kind)
    fr = frames_for(jcfg, 2)
    want = jwh.encode(jcfg, jp, jnp.asarray(fr), masks=jm)
    got = twh.encode(tcfg, tp, _t(fr), masks=tm)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_with_frames(cfgs, kind):
    jcfg, tcfg = cfgs
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 3)[0], kind)
    fr = frames_for(jcfg, 4)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, S_DEC)).astype(np.int32)
    want, _ = jreg.forward(jcfg, jp, jnp.asarray(toks),
                           frames=jnp.asarray(fr), masks=jm)
    got, aux = treg.forward(tcfg, tp, _t(toks), frames=_t(fr), masks=tm)
    assert float(aux) == 0.0 and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_forward_needs_frames(cfgs):
    _, tcfg = cfgs
    with pytest.raises(ValueError, match="frames"):
        treg.forward(tcfg, {}, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_cross(cfgs, kind):
    """The encoder memory's cross K/V of every decoder layer, (layers, B,
    S_enc, KV, hd), in f32; in the default bf16 the port's are its f32
    values rounded once."""
    jcfg, tcfg = cfgs
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 6)[0], kind)
    fr = frames_for(jcfg, 7)
    jk, jv = jwh.prefill_cross(jcfg, jp, jnp.asarray(fr), masks=jm,
                               dtype=jnp.float32)
    tk, tv = twh.prefill_cross(tcfg, tp, _t(fr), masks=tm,
                               dtype=torch.float32)
    _, kv = tattn.eff_heads(tcfg)
    assert tuple(tk.shape) == (tcfg.num_layers, B, S_ENC, kv, tcfg.head_dim)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    bk, bv = twh.prefill_cross(tcfg, tp, _t(fr), masks=tm)
    assert bk.dtype == bv.dtype == torch.bfloat16
    assert torch.equal(bk, tk.to(torch.bfloat16))
    assert torch.equal(bv, tv.to(torch.bfloat16))


@pytest.mark.parametrize("kind", KINDS)
def test_decode_steps_over_prefill_cross(cfgs, kind):
    """``prefill_cross`` fills the memory, then 16 teacher-forced decode
    steps on each side from an f32 cache: logits every step, then the
    self-attention cache (crossed back)."""
    jcfg, tcfg = cfgs
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 8)[0], kind)
    fr = frames_for(jcfg, 9)
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (B, S_DEC)).astype(np.int32)
    jc = jreg.init_cache(jcfg, B, S_DEC, dtype=jnp.float32, enc_len=S_ENC)
    jk, jv = jwh.prefill_cross(jcfg, jp, jnp.asarray(fr), masks=jm,
                               dtype=jnp.float32)
    jc = dict(jc, ck=jk, cv=jv)
    tc = treg.init_cache(tcfg, B, S_DEC, dtype=torch.float32, device="cpu")
    tc["ck"], tc["cv"] = twh.prefill_cross(tcfg, tp, _t(fr), masks=tm,
                                           dtype=torch.float32)
    jdecode = ref_decode(jcfg)
    for t in range(S_DEC):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                         masks=jm)
        tl, tc = treg.decode_step(tcfg, tp, tc, _t(toks[:, t:t + 1]), t,
                                  masks=tm)
        assert tuple(tl.shape) == (B, 1, jcfg.vocab_size)
        _close(tl.numpy(), jl)
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k])


def test_decode_matches_forward(cfgs):
    """The reference's decode-consistency check on the port: 16 decode
    steps over ``prefill_cross`` give the training forward's logits at
    every position (f32, 1e-5 of their magnitude)."""
    jcfg, tcfg = cfgs
    _, tp = model(jcfg, 11)
    fr = _t(frames_for(jcfg, 12))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, jcfg.vocab_size, (B, S_DEC)).astype(np.int32))
    full, _ = treg.forward(tcfg, tp, toks, frames=fr)
    cache = treg.init_cache(tcfg, B, S_DEC, dtype=torch.float32,
                            device="cpu")
    cache["ck"], cache["cv"] = twh.prefill_cross(tcfg, tp, fr,
                                                 dtype=torch.float32)
    got = []
    for t in range(S_DEC):
        lg, cache = treg.decode_step(tcfg, tp, cache, toks[:, t:t + 1], t)
        got.append(lg[:, 0])
    _close(torch.stack(got, dim=1).numpy(), full.numpy())


def test_init_cache_layout(cfgs):
    """bf16 by default, the reference's self-attention 'k'/'v' shapes; no
    encoder memory slots ('ck'/'cv' come from ``prefill_cross``)."""
    jcfg, tcfg = cfgs
    jc = jreg.init_cache(jcfg, 3, 8)
    tc = treg.init_cache(tcfg, 3, 8, device="cpu")
    assert set(tc) == {"k", "v"}
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].dtype == torch.bfloat16


def _batches(jcfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S_DEC + 1)).astype(np.int32)
    fr = frames_for(jcfg, seed + 1)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "frames": jnp.asarray(fr)}
    tb = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:]),
          "frames": _t(fr)}
    return jb, tb


def test_loss_and_gradients_match_reference(cfgs):
    """The masked-dense training loss with frames and the gradient of
    every leaf (the padded heads' included), each within 1e-5 of its
    magnitude."""
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 14)
    jm = one_shot(jcfg, jp)
    tm = interop.to_torch(jax.device_get(jm), device="cpu")
    jb, tb = _batches(jcfg, 15)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(jcfg, p, jm, jb), has_aux=True))(jp)
    leaves = tstep._leaf_params(tp)
    tl, _ = tstep.loss_fn(tcfg, leaves, tm, tb)
    tg = torch.autograd.grad(tl, adamw.tree_leaves(leaves))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    flat_j = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(flat_j) == len(tg)
    for g, want in zip(tg, flat_j):
        _close(g.numpy(), want)


def test_train_step_refreshes_under_per_stack_dense_flags(cfgs):
    """One step of each trainer from one reference state at step 10 (a
    refresh, at sparsity 0.4 of the schedule), frames in the batch: the
    masks bitwise, every stack's last layer all kept (its dense flag) and
    the others pruned, and the loss within 1e-5. The port's new params
    are the reference's refresh and AdamW update applied to the port's
    own gradient (whose parity is ``test_loss_and_gradients_match_
    reference``'s), each entry within two roundings of the param plus
    1e-5 of the update; and every leaf moved by over lr / 4 (Adam's
    first update at step 10 is about 0.43 lr an entry). The two
    trainers' updates differ beyond that only where a gradient is near
    Adam's eps, whose update then follows the gradient's rounding."""
    jcfg, tcfg = cfgs
    jopt, topt = _opt()
    # the reference's init, refresh and AdamW update jitted (op by op they
    # take most of the test's time on the CPU)
    js = jax.jit(lambda k: jstep.init_state(jcfg, k))(jax.random.PRNGKey(16))
    js = dataclasses.replace(js, step=jnp.int32(10))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    jb, tb = _batches(jcfg, 17)
    leaves = tstep._leaf_params(ts.params)
    tg = torch.autograd.grad(tstep.loss_fn(tcfg, leaves, ts.masks, tb)[0],
                             adamw.tree_leaves(leaves))
    tg = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(js.params),
        [jnp.asarray(g.numpy()) for g in tg])

    @jax.jit
    def refresh_and_update(js, tg):
        masks, want, _ = jsm.maybe_refresh(jcfg.blast, js.params, tg,
                                           js.masks, js.step,
                                           jreg.dense_layer_flags(jcfg))
        want, _, _ = jadamw.update(
            jopt, jsm.mask_grads(masks, tg, jcfg.blast),
            jadamw.mask_moments(js.opt_state, masks, jcfg.blast), want,
            js.step)
        return masks, want
    masks, want = refresh_and_update(js, tg)
    start = jax.tree_util.tree_leaves(jax.device_get(js.params))
    js, jmet = jax.jit(jstep.make_train_step(jcfg, jopt))(js, jb)
    ts, tmet = tstep.make_train_step(tcfg, topt)(ts, tb)
    assert ts.step == int(js.step) == 11
    assert tmet["loss"] == pytest.approx(float(jmet["loss"]), rel=1e-5)
    _masks_equal(ts.masks, jax.device_get(js.masks))
    _masks_equal(ts.masks, jax.device_get(masks))
    for path, m in ts.masks.items():
        assert bool(m[-1].all()), path
        assert not bool(m[:-1].all()), path
    lr = float(jmet["lr"])
    for i, (t, w, p0) in enumerate(zip(
            adamw.tree_leaves(ts.params),
            jax.tree_util.tree_leaves(jax.device_get(want)), start)):
        t, w, p0 = (np.asarray(a, np.float64) for a in (t.numpy(), w, p0))
        ulp = np.spacing(np.maximum(np.abs(t), np.abs(w)).astype(np.float32))
        np.testing.assert_array_less(
            np.abs(t - w), 2 * ulp + 1e-5 * np.abs(w - p0).max(),
            err_msg=f"leaf {i}")
        assert np.abs(t - p0).max() > 0.25 * lr, i


def test_export_of_the_nested_stacks_matches_reference(cfgs):
    """The launcher's one-shot masks, the pruned-dense and the packed
    exports of the encoder and decoder stacks bitwise (every leaf of the
    tree: masks, ``idx``, ``blocks``, the cast weights), the memory report
    equal, and the packed tree's round trip through ``interop``
    bit-exact."""
    from repro_torch.launch.serve import one_shot_masks
    from repro_torch.serving import export as texport
    jcfg, tcfg = cfgs
    jp, tp = model(jcfg, 18)
    jm = one_shot(jcfg, jp)
    tm = one_shot_masks(tcfg, tp, 0.8)
    _masks_equal(tm, jax.device_get(jm))
    for pack in (False, True):
        want = (jexport.pack_params if pack else jexport.prune_params)(
            jcfg, jp, jm)
        got = (texport.pack_params if pack else texport.prune_params)(
            tcfg, tp, tm)
        assert (texport.memory_report(tcfg, got)["bytes"]
                == jexport.memory_report(jcfg, want)["bytes"])
        w = interop.to_numpy(interop.to_torch(jax.device_get(want),
                                              device="cpu"))
        g = interop.to_numpy(got)
        assert [k for k, _ in _flatten(g)] == [k for k, _ in _flatten(w)]
        for (k, a), (_, b) in zip(_flatten(g), _flatten(w)):
            a, b = np.atleast_1d(a), np.atleast_1d(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=k)
        back = interop.to_numpy(interop.to_torch(g, device="cpu"))
        for (k, a), (_, b) in zip(_flatten(back), _flatten(g)):
            np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                          np.atleast_1d(b).view(np.uint8))
