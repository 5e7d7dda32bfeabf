"""whisper-large-v3 and internvl2-2b on the card, cut to two layers (two
encoder and two decoder layers for whisper) at full width in f32 (marked
``gpu``; skips without one): the packed export (``bspmm``, and the fused
GLU for the VLM) against the pruned-dense export of the same one-shot
masks, end to end through ``forward(frames=)`` and
``forward(patch_embeds=)`` within 1e-3 of the logits' magnitude (two
layers of f32 sums in other orders); whisper's teacher-forced
``decode_step``s over ``prefill_cross`` against its forward; and the
patches moving the VLM's logits. Needs no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_audio_vlm_gpu.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import bspmm as tbs  # noqa: E402
from repro_torch.launch.serve import (one_shot_masks,  # noqa: E402
                                      prune_and_pack)
from repro_torch.models import registry, whisper  # noqa: E402

LOGIT_TOL = 1e-3
B, S_ENC, S_DEC = 2, 300, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _two_layers(arch, dev):
    """(f32 config cut to two layers, packed, pruned-dense) at s = 0.8."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2, compute_dtype="float32",
                              num_encoder_layers=min(
                                  full.num_encoder_layers, 2))
    params = registry.init_params(cfg, 0, dev)
    masks = one_shot_masks(cfg, params, 0.8)
    packed = prune_and_pack(cfg, params, 0.8, True, masks=masks)
    dense = prune_and_pack(cfg, params, 0.8, False, masks=masks)
    return cfg, packed, dense


def _within(got, want, rel):
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    tol = rel * float(want.abs().max())
    assert err <= tol, f"max abs err {err} > {tol}"


def _randn(gen, shape, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


@pytest.mark.gpu
def test_whisper_two_layers_packed_against_dense(cuda):
    cfg, packed, dense = _two_layers("whisper-large-v3", cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    frames = _randn(gen, (B, S_ENC, cfg.d_model), cuda, 0.02)
    toks = torch.randint(0, cfg.vocab_size, (B, S_DEC), generator=gen,
                         device=cuda)
    with torch.inference_mode():
        want, _ = registry.forward(cfg, dense, toks, frames=frames)
        before = tbs.LAUNCHES["bspmm"]
        got, _ = registry.forward(cfg, packed, toks, frames=frames)
        # two projections in each of the 2 + 2 layers
        assert tbs.LAUNCHES["bspmm"] - before == 8
    _within(got, want, LOGIT_TOL)


@pytest.mark.gpu
def test_whisper_two_layers_decode_matches_forward(cuda):
    """The reference's decode-consistency check on the card, packed:
    ``prefill_cross`` then 32 teacher-forced decode steps against the
    training forward's logits."""
    cfg, packed, _ = _two_layers("whisper-large-v3", cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    frames = _randn(gen, (B, S_ENC, cfg.d_model), cuda, 0.02)
    toks = torch.randint(0, cfg.vocab_size, (B, S_DEC), generator=gen,
                         device=cuda)
    with torch.inference_mode():
        full, _ = registry.forward(cfg, packed, toks, frames=frames)
        cache = registry.init_cache(cfg, B, S_DEC, dtype=torch.float32,
                                    device=cuda)
        cache["ck"], cache["cv"] = whisper.prefill_cross(
            cfg, packed, frames, dtype=torch.float32)
        steps = []
        for t in range(S_DEC):
            lg, cache = registry.decode_step(cfg, packed, cache,
                                             toks[:, t:t + 1], t)
            steps.append(lg[:, 0])
    _within(torch.stack(steps, dim=1), full, LOGIT_TOL)


@pytest.mark.gpu
def test_vlm_two_layers_packed_against_dense_with_patches(cuda):
    cfg, packed, dense = _two_layers("internvl2-2b", cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    patches = _randn(gen, (B, cfg.num_patches, cfg.d_model), cuda, 0.02)
    toks = torch.randint(0, cfg.vocab_size, (B, cfg.num_patches + S_DEC),
                         generator=gen, device=cuda)
    with torch.inference_mode():
        want, _ = registry.forward(cfg, dense, toks, patch_embeds=patches)
        before = dict(tbs.LAUNCHES)
        got, _ = registry.forward(cfg, packed, toks, patch_embeds=patches)
        assert tbs.LAUNCHES["bspmm"] - before["bspmm"] == 2
        text, _ = registry.forward(cfg, packed, toks)
    _within(got, want, LOGIT_TOL)
    moved = (got - text).abs().amax(dim=-1)
    assert bool((moved > 1e-3 * text.abs().max()).all())
