"""The port's engine with mixed batching and the prefix cache together
(``mixed=True, prefix_cache=True``) against the reference engine in the
same mode, on the shared scenario of ``_torch_engine_modes.py``: greedy
streams equal (a divergence only at a reference top-2 margin below
1e-5), block tables, lanes, frontiers and the pool's page states equal
after every step, the reference's counters equal, and the same streams
as the port's phased paged engine."""
import pytest

pytest.importorskip("torch")

import _torch_engine_modes as modes  # noqa: E402

MODE = dict(mixed=True, prefix_cache=True)


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


def test_tails_ride_in_decode_steps(run):
    """Prefix-cached tails prefill inside the mixed steps: hits and
    copies happen, and no decode step stalls."""
    st = run["stats_t"]
    assert st["stalled_decode_steps"] == 0 and st["mixed_steps"] > 0
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert st["cache_evicted_pages"] > 0
    assert (st["prefill_tokens"] + st["prefill_tokens_skipped"]
            == st["prompt_tokens"])
