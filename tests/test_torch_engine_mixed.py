"""The port's engine with mixed decode+prefill batching
(``mixed=True``) against the reference engine in the same mode, on the
shared scenario of ``_torch_engine_modes.py`` (ragged prompts, more
requests than lanes, a page-gated head, a truncated request): greedy
streams equal (a divergence only at a reference top-2 margin below
1e-5), block tables, lanes, frontiers and page accounting equal after
every step, the reference's counters equal, and the same streams as the
port's phased paged engine."""
import pytest

pytest.importorskip("torch")

import _torch_engine_modes as modes  # noqa: E402

MODE = dict(mixed=True)


@pytest.fixture(scope="module", params=["tiny", "smoke"])
def run(request):
    return modes.lockstep(request.param, MODE, n_pages=10)


def test_streams_equal_reference(run):
    modes.check_streams(run)


def test_streams_equal_port_phased_paged(run):
    modes.check_phased(run)


@pytest.mark.parametrize("key", ["lanes", "frontier", "bt", "free", "referenced", "peak"])
def test_state_equal_after_every_step(run, key):
    modes.check_snapshots(run, key)


@pytest.mark.parametrize("key", modes.COUNTERS)
def test_counter_equals_reference(run, key):
    assert run["stats_t"].get(key, 0) == run["stats_j"].get(key, 0), key


def test_decode_never_stalls(run):
    """Prompts ride in the decode steps: no blocking prefill call ran
    while a lane was decoding, and the budget spent decode tokens
    first."""
    st = run["stats_t"]
    assert st["stalled_decode_steps"] == 0
    assert st["mixed_steps"] > 0 and st["decode_slabs"] > 0
    assert st["admission_rejections"] > 0
    assert st["prefill_tokens"] == st["prompt_tokens"]
    assert run["te"].scheduler.prefill_token_budget == (
        modes.KW["max_batch"] + modes.KW["prefill_chunk"])
