"""The four dense ``--arch`` models' greedy streams and counters in the
engine's mixed decode+prefill and prefix-cache modes, port against
reference with shared weights (the scenario of ``test_torch_archs.py``,
kept in a file of its own so that parallel workers share the reference's
compile time)."""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

from test_torch_archs import ARCHS, check_streams  # noqa: E402


@pytest.mark.parametrize("mode", ["mixed", "prefix"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, mode):
    check_streams(arch, mode)
