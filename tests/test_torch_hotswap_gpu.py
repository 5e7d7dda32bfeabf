"""Sealed artifacts and the weight generations on the card (marked
``gpu``; skips without one): a seal and a replay of the canaries on one
card agree bitwise, so the exact gates hold; a slab split by weight
generation leaves the masked lanes' pool pages and device state bitwise
unchanged; streams admitted before a swap equal a run without it, and
those admitted after it a run on the new weights, bitwise. Needs no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_hotswap_gpu.py

``split_slab_calls`` also runs on the CPU (``test_torch_hotswap.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_models import LLAMA32_1B_SMOKE  # noqa: E402
from repro_torch.core import sparse_mlp as sm  # noqa: E402
from repro_torch.core.prune_grow import initial_mask  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import artifact, export, hotswap  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

KW = dict(max_batch=4, max_len=64, prefill_chunk=4, page_size=4, slab_k=4)
STATE = ("pending", "frontier", "remaining", "offsets", "faulted")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def packed(cfg, dev, seed):
    params = registry.init_params(cfg, seed, device=dev)
    spec = dataclasses.replace(cfg.blast, s_init=0.5, s_max=0.5)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return export.pack_params(cfg, params, masks)


def prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _snap(eng, lanes):
    """The rows of ``lanes`` in the KV cache (their pool pages, or their
    slab rows) and in the device state."""
    out = {}
    for i in lanes:
        if eng.paged:
            idx = torch.as_tensor(eng.lanes[i].pages, dtype=torch.long,
                                  device=eng.device)
        else:
            idx = torch.as_tensor([i], dtype=torch.long, device=eng.device)
        out[i] = ([eng.cache[n].index_select(1, idx).clone()
                   for n in ("k", "v")]
                  + [eng._dstate[k][i].clone() for k in STATE])
    return out


def split_slab_calls(cfg, old, new, device, **mode):
    """Two lanes decode on ``old``; the generation flips to ``new`` (no
    artifact: ``hotswap._flip_generation``) and two more lanes admit.
    Every slab call of the next steps is observed; returns (calls, each
    as (lanes of the call, masked lanes, their rows before, after), the
    engine)."""
    eng = Engine(cfg, old, device=device, **dict(KW, **mode))
    ps = prompts(cfg, (9, 6, 7, 5))
    for p in ps[:2]:
        eng.submit(p, 12)
    eng.step()
    hotswap._flip_generation(eng, new)
    for p in ps[2:]:
        eng.submit(p, 12)
    calls = []
    real = eng._slab_call

    def spy(params, lanes):
        masked = [i for i in eng.active_lanes if i not in lanes]
        before = _snap(eng, masked)
        real(params, lanes)
        calls.append((list(lanes), masked, before, _snap(eng, masked)))

    eng._slab_call = spy
    for _ in range(2):
        eng.step()
    return calls, eng


def check_split_calls(calls):
    split = [c for c in calls if c[1]]
    assert split, "no slab ran with lanes masked out"
    for lanes, masked, before, after in split:
        for i in masked:
            for a, b in zip(before[i], after[i]):
                assert a.dtype == b.dtype and torch.equal(a, b), (lanes, i)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_split_slab_leaves_masked_lanes_bitwise(cuda, paged):
    cfg = LLAMA32_1B_SMOKE
    calls, eng = split_slab_calls(cfg, packed(cfg, cuda, 0),
                                  packed(cfg, cuda, 7), cuda, paged=paged)
    check_split_calls(calls)
    assert {eng.lanes[i].gen for i in eng.active_lanes} == {0, 1}


@pytest.mark.gpu
def test_seal_then_replay_canaries_bitwise(cuda, tmp_path):
    """Sealed on the card, replayed on the card: 0 token mismatches and
    0.0 logit drift (the exact default gates), twice."""
    cfg = LLAMA32_1B_SMOKE
    params = packed(cfg, cuda, 0)
    d = str(tmp_path / "art")
    manifest = artifact.seal(cfg, params, d)
    for _ in range(2):
        loaded, _ = artifact.load(d, cfg, run_canaries=True, device=cuda)
    gold = artifact.golden_logits(d, manifest)
    for i, c in enumerate(manifest["canaries"]):
        toks, logits = artifact.canary_run(cfg, loaded, c["prompt"],
                                           len(c["tokens"]))
        assert toks.tolist() == c["tokens"]
        np.testing.assert_array_equal(logits, gold[i])


@pytest.mark.gpu
@pytest.mark.parametrize("mixed", [False, True], ids=["phased", "mixed"])
def test_mid_stream_swap_streams_bitwise(cuda, tmp_path, mixed):
    cfg = LLAMA32_1B_SMOKE
    old, new = packed(cfg, cuda, 0), packed(cfg, cuda, 7)
    d = str(tmp_path / "new")
    artifact.seal(cfg, new, d)
    ps = prompts(cfg, (9, 6, 7, 5))

    def base(params):
        eng = Engine(cfg, params, device=cuda, mixed=mixed, **KW)
        for p in ps:
            eng.submit(p, 12)
        return eng.run()

    want_old, want_new = base(old), base(new)
    eng = Engine(cfg, old, device=cuda, mixed=mixed, **KW)
    for p in ps[:2]:
        eng.submit(p, 12)
    out = {r.uid: r for r in eng.step()}
    rep = eng.swap_weights(d, monitor_steps=3)
    for p in ps[2:]:
        eng.submit(p, 12)
    out.update(eng.run())
    for u, want in ((0, want_old), (1, want_old), (2, want_new),
                    (3, want_new)):
        np.testing.assert_array_equal(out[u].generated, want[u].generated)
    assert rep.state == hotswap.COMMITTED and len(eng._gen_params) == 1
