"""The port's engine with the contiguous ``(B, max_len)`` cache
(``paged=False``) against the reference engine in the same mode, on the
shared scenario of ``_torch_engine_modes.py`` (ragged prompts, more
requests than lanes, a truncated request): greedy streams equal (a
divergence only at a reference top-2 margin below 1e-5), lanes and
frontiers equal after every step, the reference's counters equal, and
the same streams as the port's phased paged engine."""
import pytest

pytest.importorskip("torch")

import _torch_engine_modes as modes  # noqa: E402

MODE = dict(paged=False)


@pytest.fixture(scope="module", params=["tiny", "smoke"])
def run(request):
    return modes.lockstep(request.param, MODE)


def test_streams_equal_reference(run):
    modes.check_streams(run)


def test_streams_equal_port_phased_paged(run):
    modes.check_phased(run)


@pytest.mark.parametrize("key", ["lanes", "frontier"])
def test_state_equal_after_every_step(run, key):
    modes.check_snapshots(run, key)


@pytest.mark.parametrize("key", modes.COUNTERS)
def test_counter_equals_reference(run, key):
    assert run["stats_t"].get(key, 0) == run["stats_j"].get(key, 0), key


def test_slab_is_the_kv_footprint(run):
    """The contiguous engine holds the whole slab: its peak KV bytes are
    the slab's, which is what ``kv_bytes_contiguous_equiv`` states, and
    it launches no paged attention (no pool, no pages read)."""
    st, te = run["stats_t"], run["te"]
    slab = sum(t.numel() * t.element_size() for t in te.cache.values())
    assert st["peak_kv_bytes"] == slab == st["kv_bytes_contiguous_equiv"]
    assert te.pool is None and st["pages_read"] == 0
    assert te.cache["k"].shape[1:3] == (modes.KW["max_batch"],
                                        modes.KW["max_len"])
    assert st["truncated"] == 1 and st["stalled_decode_steps"] > 0
    with pytest.raises(KeyError):
        te.block_tables
