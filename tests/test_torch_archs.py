"""The four dense ``--arch`` models (stablelm-3b, stablelm-12b, qwen2-7b,
gemma2-27b) at their SMOKE size, port against reference with the
reference's weights shared through ``interop``: the training forward's
logits (layernorm, qk-norm, QKV bias, padded query heads, GeGLU, the
attention and final softcaps, local/global windows and scaled tied
embeddings), the packed serving weights bitwise, and the engines' greedy
streams, one case per (architecture, engine mode): paged and contiguous
here, mixed and prefix-cache in ``test_torch_archs_modes.py``.

Prompts are 40-48 tokens, longer than gemma2's smoke window of 32, and
share a 24-token prefix (so the prefix cache hits). Streams must be
equal; a divergence is accepted only where the reference's top-2 logit
margin at that step is a near-tie (ROADMAP's parity bar)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _ref_margin  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.core.prune_grow import initial_mask  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import engine as jengine, export as jexport  # noqa: E402
from repro_torch import configs as tconfigs, interop  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serving import engine as tengine, export as texport  # noqa: E402

ARCHS = ("stablelm-3b", "stablelm-12b", "qwen2-7b", "gemma2-27b")
ENGINE = dict(max_new_tokens=6, max_batch=2, prefill_chunk=16,
              page_size=16)
PREFIX, N_PROMPTS = 24, 3
# the stats both engines must agree on, by mode
STATS = ("generated_tokens", "prefill_chunks", "decode_slabs",
         "peak_kv_bytes", "pages_read", "truncated")
MODE_STATS = {"mixed": ("mixed_steps", "stalled_decode_steps"),
              "prefix": ("prefix_hits", "prefill_tokens_skipped",
                         "cow_copies")}
# forward logits: the stated 2e-5 absolute; stablelm-3b at 1e-4, where
# the packages differ by up to 5.2e-5 at S = 40 (4.7e-6 at S = 12): the
# reference's init makes its four MHA heads' attention logits 16x those
# of the true fan-in (ROADMAP §3), and the sharp softmax carries f32
# summation-order differences through the layers
FWD_ATOL = {"stablelm-3b": 1e-4}
MODES = {"paged": dict(paged=True), "contiguous": dict(paged=False),
         "mixed": dict(paged=True, mixed=True),
         "prefix": dict(paged=True, prefix_cache=True)}


@functools.cache
def shared(arch):
    """(reference cfg, port cfg, reference f32 params, port f32 params,
    the launcher's one-shot masks at 0.8 (numpy), reference packed, port
    packed), the port's weights taken from the reference's."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    spec = dataclasses.replace(jcfg.blast, s_init=0.8, s_max=0.8)
    masks = {}
    for path in jreg.sparse_paths(jcfg):
        bi, bo = jsm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        masks[path] = jax.vmap(lambda w: initial_mask(pspec, w))(
            jsm.get_path(params, path))
    jp = jexport.pack_params(jcfg, params, masks)
    host = jax.device_get(params)
    tparams = interop.to_torch(host, device="cpu")
    tmasks = interop.to_torch(jax.device_get(masks), device="cpu")
    tp = texport.pack_params(tcfg, tparams, tmasks)
    return jcfg, tcfg, params, tparams, jax.device_get(masks), jp, tp


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=PREFIX)
    return [np.concatenate([head, rng.integers(
        0, vocab, size=int(n) - PREFIX)]).astype(np.int32)
        for n in rng.integers(40, 49, size=N_PROMPTS)]


def check_streams(arch, mode):
    jcfg, tcfg, _, _, _, jp, tp = shared(arch)
    ps = prompts(jcfg.vocab_size)
    want, jst = jengine.generate(jcfg, jp, ps, **ENGINE, **MODES[mode])
    got, tst = tengine.generate(tcfg, tp, ps, **ENGINE, **MODES[mode],
                                device="cpu")
    assert len(got) == len(want) == N_PROMPTS
    for p, g, w in zip(ps, got, want):
        _assert_same_or_near_tie(
            np.asarray(g), np.asarray(w), p.size,
            lambda seq: _ref_margin(jcfg, jp, seq, ENGINE["page_size"]))
    for k in STATS + MODE_STATS.get(mode, ()):
        assert tst[k] == jst[k], k
    if mode == "prefix":
        assert tst["prefix_hits"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, params, tparams, _, _, _ = shared(arch)
    assert tcfg.compute_dtype == "float32"
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, _ = jreg.forward(jcfg, params, jnp.asarray(toks))
    got, _ = treg.forward(tcfg, tparams, torch.from_numpy(toks))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=FWD_ATOL.get(arch, 2e-5))


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_params_bitwise(arch):
    jcfg, tcfg, _, _, masks, jp, tp = shared(arch)
    for path in masks:
        j, t = jsm.get_path(jp, path), jsm.get_path(tp, path)
        assert (t.kb, t.joint) == (j.kb, j.joint)
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
        np.testing.assert_array_equal(interop.array(t.blocks).view(np.int16),
                                      np.asarray(j.blocks).view(np.int16))


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, mode):
    check_streams(arch, mode)


def test_zeroed_padded_heads_equal_the_unpadded_model():
    """qwen2-7b's smoke shape pads its 4 query heads over 2 kv heads to 32
    (G = 16). Init zeroes the padded heads' ``wq`` columns and ``wo``
    rows, and the model then computes exactly the unpadded one whose head
    h reads the padded layout's kv head h // G (written here as an MHA
    model carrying those kv weights); live padded heads would change it."""
    from repro_torch.models import attention
    cfg = tconfigs.get_config("qwen2-7b", smoke=True)
    h, kv = attention.eff_heads(cfg)
    n = cfg.num_heads
    assert (n, h, cfg.qkv_bias) == (4, 32, True)
    p = treg.init_params(cfg, 0, "cpu")
    a = p["layers"]["attn"]
    assert not a["wq"][..., n:, :].any() and not a["wo"][:, n:].any()
    assert a["wq"][..., :n, :].any() and a["wo"][:, :n].any()
    kv_of = torch.arange(n) // (h // kv)
    live = dataclasses.replace(cfg, pad_heads_to=0, num_kv_heads=n)
    lp = dict(p, layers=dict(p["layers"], attn=dict(
        a, wq=a["wq"][..., :n, :], wo=a["wo"][:, :n], bq=a["bq"][:, :n],
        wk=a["wk"][:, :, kv_of], wv=a["wv"][:, :, kv_of],
        bk=a["bk"][:, kv_of], bv=a["bv"][:, kv_of])))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32))
    padded = treg.forward(cfg, p, toks)[0]
    np.testing.assert_allclose(padded.numpy(),
                               treg.forward(live, lp, toks)[0].numpy(),
                               rtol=0, atol=1e-5)
    gen = torch.Generator().manual_seed(3)
    a["wo"][:, n:] = 0.2 * torch.randn(a["wo"][:, n:].shape, generator=gen)
    assert (treg.forward(cfg, p, toks)[0] - padded).abs().max() > 1e-3
