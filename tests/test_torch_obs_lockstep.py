"""The port engine's span and event stream against the reference's, in
lockstep on the scenario of ``_torch_engine_modes.py`` (11 ragged
requests on 3 lanes, shared prefixes, a page-gate block, a truncation)
in each mode: phased paged, contiguous, mixed, prefix cache, and mixed
with the prefix cache. The two rings must hold the same sequence of
(name, attrs), every attr equal, leaving out only the seconds each side
reads from its own clock (span times, ``queued_s``, ``ttft_s``).

The port's repairs recorded in ROADMAP §3 that could change an event
stream do not arise here: no step dies (the parked swept results and the
relaunch of a lane whose first token had not landed are the recovery
scenarios of ``test_torch_obs_faults.py``), and no swap window opens (a
mixed step's stall count and a split slab's wider page read are
counters, not span attrs)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_engine_modes as modes  # noqa: E402
import _torch_serving as ts  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

MODES = {"phased": ({}, {}), "contiguous": (dict(paged=False), {}),
         "mixed": (dict(mixed=True), dict(n_pages=10)),
         "prefix": (dict(prefix_cache=True), {}),
         "mixed_prefix": (dict(mixed=True, prefix_cache=True), {})}
SPANS = {"phased": {"prefill.chunks", "decode.slab", "admit.blocked"},
         "contiguous": {"prefill.chunks", "decode.slab"},
         "mixed": {"mixed.step", "decode.slab"},
         "prefix": {"mixed.step", "decode.slab"},
         "mixed_prefix": {"mixed.step", "decode.slab"}}


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request):
    mode, kw = MODES[request.param]
    jt, tt = JTracer(), Tracer()
    out = modes.lockstep("tiny", mode, tracers=(jt, tt), **kw)
    return dict(name=request.param, jt=jt, tt=tt, out=out)


def test_streams_unchanged_by_tracing(run):
    modes.check_streams(run["out"])


def test_event_sequences_equal_the_reference(run):
    got, want = ts.events(run["tt"].records), ts.events(run["jt"].records)
    assert len(got) == len(want) > 0
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {n}: {g} != {w}"


def test_every_request_has_its_timeline(run):
    names = {s.name for s in run["tt"].records}
    assert SPANS[run["name"]] <= names, names
    for u in run["out"]["done_t"]:
        tl = [s["name"] for s in run["tt"].spans_for(u)]
        assert tl[0] == "request.queued" and tl[-1] == "request.finish"
        assert tl.count("request.admitted") == 1


def test_span_times_are_monotonic_host_times(run):
    recs = list(run["tt"].records)
    assert all(s.t1 >= s.t0 for s in recs)
    timed = [s for s in recs if s.t1 > s.t0]
    assert timed and all(s.name in ("prefill.chunks", "decode.slab",
                                    "mixed.step") for s in timed)
