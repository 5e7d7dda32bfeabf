"""The port's launchers on the MoE ``--arch`` ids, on the CPU.
``launch.serve --smoke --device cpu --packed`` gives the JAX launcher's
token rows when both start from the same weights (the reference's seeded
params, crossed through ``interop``: the two packages' seeds draw
different numbers), phased and ``--mixed``; ``--seal`` then
``--artifact`` (canaries replayed) serves the same rows; and
``launch.train`` trains the smoke config with the aux term in its loss."""
import contextlib
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

SMALL = ["--smoke", "--prompt-len", "8", "--new-tokens", "6", "--batch",
         "3"]


def _reference_rows(monkeypatch, argv):
    """The last two token rows the JAX launcher prints for ``argv``."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main()
    monkeypatch.undo()
    rows = buf.getvalue().strip().splitlines()[-2:]
    return [[int(t) for t in re.findall(r"-?\d+", r)] for r in rows]


def _with_reference_params(monkeypatch, arch):
    """Make the port's launcher start from the reference launcher's
    seeded params (``train.step.init_state`` at PRNGKey(0))."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    params = interop.to_torch(jax.device_get(
        jstep.init_state(jcfg, jax.random.PRNGKey(0)).params), device="cpu")
    monkeypatch.setattr(treg, "init_params",
                        lambda cfg, seed, device: params)


@pytest.mark.parametrize("mode", [[], ["--mixed"]], ids=["phased", "mixed"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_serve_rows_match_the_reference_launcher(arch, mode, monkeypatch):
    argv = ["--arch", arch, "--packed", *SMALL, *mode]
    want = _reference_rows(monkeypatch, argv)
    _with_reference_params(monkeypatch, arch)
    res = serve.main([*argv, "--device", "cpu"])
    assert [list(map(int, t)) for t in res["tokens"][:2]] == want
    assert res["stats"]["generated_tokens"] == 18
    assert res["memory"]["bytes"] > 0


def test_seal_then_artifact_serves_the_same_rows(tmp_path, monkeypatch,
                                                 capsys):
    arch = "deepseek-moe-16b"
    argv = ["--arch", arch, "--packed", *SMALL]
    want = _reference_rows(monkeypatch, argv)
    _with_reference_params(monkeypatch, arch)
    d = str(tmp_path / "art")
    assert serve.main([*argv, "--device", "cpu", "--seal", d]) is None
    out = capsys.readouterr().out
    assert f"sealed {d}" in out
    res = serve.main([*argv, "--device", "cpu", "--artifact", d])
    out = capsys.readouterr().out
    n_canaries = int(re.search(r"(\d+) canaries replayed", out).group(1))
    assert "artifact OK" in out and n_canaries > 0
    assert [list(map(int, t)) for t in res["tokens"][:2]] == want


def test_train_smoke_runs_with_the_aux_term(capsys):
    state, hist = train.main(["--arch", "deepseek-moe-16b", "--smoke",
                              "--device", "cpu", "--batch", "2", "--seq",
                              "16", "--steps", "6"])
    logged = [h for h in hist if "loss" in h]
    assert state.step == 6 and logged
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in logged)
    assert "done: final loss" in capsys.readouterr().out
