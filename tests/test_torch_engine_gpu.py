"""The port's engine on the card (marked ``gpu``; skips without one):
a mixed call that carries only a mid-prompt chunk queues its work
without a host sync, and the mixed engine's streams equal the phased
engine's; preemption downloads a lane's pages bitwise and completely
before it frees them, and the restore scatters them back bitwise; a
host-side crash is recovered on the card. Needs no JAX:

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
from repro_torch.serving import faults, recovery  # noqa: E402

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


def _slots(cache, pages, n):
    """K and V of logical slots [0, n) held in pool ``pages``, as raw
    16-bit words on the host."""
    out = []
    for name in ("k", "v"):
        t = cache[name][:, pages]
        t = t.reshape(t.shape[0], -1, *t.shape[3:])[:, :n]
        out.append(t.view(torch.int16).cpu())
    return out


def _lane_of(eng, uid):
    return next(i for i in eng.active_lanes if eng.lanes[i].req.uid == uid)


def _same_or_near_tie(cfg, params, got, want, plen, dev):
    if np.array_equal(got, want):
        return
    t = int(np.argmax(got[plen:] != want[plen:]))
    assert _margin(cfg, params, want[:plen + t], dev) < 1e-4


@pytest.mark.gpu
def test_preempt_and_restore_move_pages_bitwise(cuda):
    """Request 0 is preempted after its first slab: the record holds its
    pool pages' bits, taken before ``preempt`` returned (the freed pages
    are overwritten with NaN at once), and the restore puts the same bits
    back in slots [0, frontier) of its new pages. The streams equal an
    uninterrupted run's (a divergence only at a near-tie: the restored
    lane changes the paged kernel's split plan)."""
    cfg = LLAMA32_1B_SMOKE
    params = _packed(cfg, cuda)
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
          for n in (9, 6)]
    kw = dict(KW, max_batch=2)
    want, _ = tengine.generate(cfg, params, ps, max_new_tokens=12,
                               device=cuda, **kw)
    eng = tengine.Engine(cfg, params, device=cuda, **kw)
    for p in ps:
        eng.submit(p, 12)
    eng.step()
    i = _lane_of(eng, 0)
    front = int(eng.frontiers[i])
    pages = eng.lanes[i].pages[:eng.pool.slots_for(front)]
    k0, v0 = _slots(eng.cache, pages, front)
    eng.preempt(i)
    with torch.inference_mode():
        for name in ("k", "v"):
            eng.cache[name].index_fill_(
                1, torch.tensor(pages, device=cuda), float("nan"))
    rec = eng._offload._recs[0]
    assert rec.k.is_pinned() and rec.k.dtype == torch.bfloat16
    kr = rec.k.reshape(rec.k.shape[0], -1, *rec.k.shape[3:])[:, :front]
    assert torch.equal(kr.view(torch.int16), k0)
    assert rec.checksums == [rec.page_crc(j) for j in range(len(pages))]
    eng.step()                                    # restores request 0
    j = _lane_of(eng, 0)
    k1, v1 = _slots(eng.cache, eng.lanes[j].pages, front)
    assert torch.equal(k1, k0) and torch.equal(v1, v0)
    got = eng.run()
    st = eng.stats
    assert st["restored_pages"] == st["offloaded_pages"] == len(pages)
    assert st["re_prefilled_tokens"] == 0
    for u, p in enumerate(ps):
        _same_or_near_tie(cfg, params, got[u].tokens, want[u], p.size, cuda)


@pytest.mark.gpu
def test_host_crash_recovers_on_the_card(cuda):
    """A host-side crash at step 2: ``Supervisor.recover`` salvages both
    live lanes to pinned host memory and the rebuilt engine restores them
    with no re-prefill."""
    cfg = LLAMA32_1B_SMOKE
    params = _packed(cfg, cuda)
    rng = np.random.default_rng(2)
    ps = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
          for n in (7, 5, 9)]
    kw = dict(KW, max_batch=2)
    want, _ = tengine.generate(cfg, params, ps, max_new_tokens=12,
                               device=cuda, **kw)
    eng = tengine.Engine(cfg, params, device=cuda,
                         faults=faults.FaultPlan().crash(2), **kw)
    for p in ps:
        eng.submit(p, 12)
    out, summaries = {}, []
    for _ in range(100):
        if not (len(eng.scheduler) or eng.active_lanes or eng._preempted
                or eng._pending_results):
            break
        try:
            out.update((r.uid, r) for r in eng.step())
        except faults.EngineCrashError as e:
            summaries.append(recovery.Supervisor(eng).recover(e))
    [summary] = summaries
    assert summary["salvaged_lanes"] == 2 and summary["salvaged_bytes"] > 0
    st = eng.finalize_stats()
    assert st["re_prefilled_tokens"] == 0
    assert st["recovered_zero_reprefill"] == 2
    for u, p in enumerate(ps):
        _same_or_near_tie(cfg, params, out[u].tokens, want[u], p.size, cuda)
