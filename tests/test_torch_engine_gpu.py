"""The port's engine on the card (marked ``gpu``; skips without one):
a mixed call that carries only a mid-prompt chunk queues its work
without a host sync, and the mixed engine's streams equal the phased
engine's. Needs no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_engine_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_models import LLAMA32_1B_SMOKE  # noqa: E402
from repro_torch.core import sparse_mlp as sm  # noqa: E402
from repro_torch.core.prune_grow import initial_mask  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import engine as tengine, export  # noqa: E402

KW = dict(max_batch=1, max_len=64, prefill_chunk=4, page_size=4, slab_k=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(cfg, dev):
    params = registry.init_params(cfg, 0, device=dev)
    spec = dataclasses.replace(cfg.blast, s_init=0.5, s_max=0.5)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return export.pack_params(cfg, params, masks)


@pytest.mark.gpu
def test_mid_prompt_mixed_calls_do_not_sync(cuda):
    """A 40-token prompt on one lane, chunks of 4 under a budget of 5:
    its first calls carry only a mid-prompt chunk and must not sync
    (``torch.cuda.set_sync_debug_mode("error")`` raises at PyTorch's
    own sync points: blocking copies, ``.item()``, ``.cpu()``); the
    finished stream equals the phased engine's."""
    cfg = LLAMA32_1B_SMOKE
    params = _packed(cfg, cuda)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=40).astype(np.int32)
    # a first run builds the kernels and caches their plans
    want, _ = tengine.generate(cfg, params, [prompt], max_new_tokens=6,
                               device=cuda, **KW)
    eng = tengine.Engine(cfg, params, mixed=True, device=cuda, **KW)
    uid = eng.submit(prompt, 6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng._prefilling == {0: 12}
    assert eng.stats["mixed_steps"] == 3
    got = eng.run()[uid].tokens
    assert eng.stats["stalled_decode_steps"] == 0
    if not np.array_equal(got, want[0]):
        # summation order may differ between the two paths' shapes: a
        # divergence is accepted only at a near-tie
        t = int(np.argmax(got != want[0]))
        assert _margin(cfg, params, want[0][:t], cuda) < 1e-4


def _margin(cfg, params, seq, dev):
    from repro_torch.models import transformer
    pages = -(-len(seq) // 4)
    with torch.inference_mode():
        logits, _ = transformer.paged_prefill_chunk(
            cfg, params, transformer.init_paged_cache(cfg, pages, 4,
                                                      device=dev),
            torch.as_tensor(seq, device=dev)[None], 0,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.arange(pages, dtype=torch.int32, device=dev)[None],
            read_pages=pages)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])
