"""The port's engine with the radix-tree prefix cache
(``prefix_cache=True``, phased) against the reference engine in the same
mode, on the shared scenario of ``_torch_engine_modes.py`` (shared
prefixes diverging at page boundaries and inside pages, a repeated
prompt, more requests than lanes, a pool small enough for LRU eviction
and a page-gated head): greedy streams equal (a divergence only at a
reference top-2 margin below 1e-5), block tables, lanes, frontiers and
the pool's page states equal after every step, the reference's counters
equal, and the same streams as the port's phased paged engine without
the cache."""
import pytest

pytest.importorskip("torch")

import _torch_engine_modes as modes  # noqa: E402

MODE = dict(prefix_cache=True)


@pytest.fixture(scope="module", params=["tiny", "smoke"])
def run(request):
    return modes.lockstep(request.param, MODE)


def test_streams_equal_reference(run):
    modes.check_streams(run)


def test_streams_equal_port_phased_paged(run):
    modes.check_phased(run)


@pytest.mark.parametrize("key", ["lanes", "frontier", "bt", "free", "referenced", "cached_idle",
                                 "peak"])
def test_state_equal_after_every_step(run, key):
    modes.check_snapshots(run, key)


@pytest.mark.parametrize("key", modes.COUNTERS)
def test_counter_equals_reference(run, key):
    assert run["stats_t"].get(key, 0) == run["stats_j"].get(key, 0), key


def test_traffic_exercises_the_cache(run):
    """Hits, copy-on-write copies, skipped prefill, LRU eviction and a
    blocked head all happened; computed + skipped prompt tokens add up
    to the demand."""
    st = run["stats_t"]
    assert st["prefix_hits"] > 0 and st["prefix_misses"] > 0
    assert st["cow_copies"] > 0 and st["cache_evicted_pages"] > 0
    assert st["admission_rejections"] > 0
    assert (st["prefill_tokens"] + st["prefill_tokens_skipped"]
            == st["prompt_tokens"])
    assert st["stalled_decode_steps"] > 0          # phased tails block
    assert st["cached_pages"] == run["te"].pool.cached_pages > 0
    assert st["peak_kv_bytes_referenced"] <= st["peak_kv_bytes"]
