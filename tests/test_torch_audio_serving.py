"""Whisper (``audio``) served through the port's ``serve_loop`` on the
CPU, against the reference: ``generate(frames=)``'s greedy streams on the
smoke model and its MHA variant, with the pruned-dense and the packed
export of the one-shot prune at s = 0.8 (a stream may leave the
reference's only where the reference's top-2 margin there is a near-tie,
< 1e-5); the cross-attention memory ``prefill_with_decode`` builds (the
encoder's length, bf16, ``prefill_cross``'s values, no unused
``max_len``-long memory); frames given as a tensor; and the engine
refusing the family, as the reference's does. Weights cross from the
port's seeded init (``test_torch_whisper.model``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _margin  # noqa: E402
from test_torch_rwkv6 import _t, one_shot  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402
from test_torch_whisper import frames_for, model, smoke_cfg  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro.serving import serve_loop as jsl  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import serve_loop as tsl  # noqa: E402

LANES, PLEN, NEW, S_ENC = 3, 9, 8, 20


def _served(jcfg, seed, packed):
    jp, _ = model(jcfg, seed)
    m = one_shot(jcfg, jp)
    jsv = (jexport.pack_params(jcfg, jp, m) if packed
           else jexport.prune_params(jcfg, jp, m))
    return jsv, interop.to_torch(jax.device_get(jsv), device="cpu")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("variant", ["smoke", "mha"])
def test_generate_with_frames_matches_reference(variant, packed):
    jcfg = smoke_cfg(variant)
    tcfg = port_cfg(jcfg)
    jsv, tsv = _served(jcfg, 21, packed)
    fr = frames_for(jcfg, 22, b=LANES, s=S_ENC)
    prompts = np.random.default_rng(23).integers(
        0, jcfg.vocab_size, (LANES, PLEN)).astype(np.int32)
    want, _ = jsl.generate(jcfg, jsv, jnp.asarray(prompts),
                           max_new_tokens=NEW, frames=jnp.asarray(fr))
    got, st = tsl.generate(tcfg, tsv, prompts, max_new_tokens=NEW,
                           frames=fr, device="cpu")
    assert got.shape == (LANES, PLEN + NEW) and got.dtype == np.int32
    assert st["tok_per_s"] > 0
    for lane, (g, w) in enumerate(zip(got, np.asarray(want))):
        def margin(seq, lane=lane):
            last, _ = jsl.prefill_with_decode(
                jcfg, jsv, jnp.asarray(seq)[None], len(seq),
                frames=jnp.asarray(fr[lane:lane + 1]))
            return _margin(last[0])
        _assert_same_or_near_tie(g, w, PLEN, margin)


def test_prefill_builds_the_encoder_memory_once():
    """The cache ``prefill_with_decode`` returns holds ``prefill_cross``'s
    bf16 memory at the encoder's length (not ``max_len``), beside the
    ``max_len``-long self-attention cache; frames given as a tensor serve
    the same stream as the numpy array."""
    jcfg = smoke_cfg()
    tcfg = port_cfg(jcfg)
    _, tsv = _served(jcfg, 24, True)
    fr = frames_for(jcfg, 25, b=2, s=S_ENC)
    prompts = np.random.default_rng(26).integers(
        0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    _, cache = tsl.prefill_with_decode(tcfg, tsv, prompts, 32, frames=fr,
                                       device="cpu")
    ck, cv = twh.prefill_cross(tcfg, tsv, _t(fr))
    assert cache["ck"].dtype == torch.bfloat16
    assert tuple(cache["ck"].shape[:3]) == (tcfg.num_layers, 2, S_ENC)
    assert tuple(cache["k"].shape[:3]) == (tcfg.num_layers, 2, 32)
    assert torch.equal(cache["ck"], ck) and torch.equal(cache["cv"], cv)
    a, _ = tsl.generate(tcfg, tsv, prompts, max_new_tokens=6, frames=fr,
                        device="cpu")
    b, _ = tsl.generate(tcfg, tsv, prompts, max_new_tokens=6,
                        frames=_t(fr), device="cpu")
    np.testing.assert_array_equal(a, b)


def test_engine_refuses_whisper():
    tcfg = port_cfg(smoke_cfg())
    assert not treg.supports_prefill_chunk(tcfg)
    assert not treg.supports_paged(tcfg) and not treg.supports_mixed(tcfg)
    with pytest.raises(NotImplementedError, match="serve_loop.generate"):
        tengine.Engine(tcfg, {}, max_batch=1, max_len=8, device="cpu")
