"""The port's launchers (``repro_torch.launch.serve`` / ``.train``) on the
CPU: their parsers carry the reference's options and defaults plus
``--device``; ``prune_and_pack`` equals the reference launcher's one-shot
prune and pack bitwise; and each entry point a user calls runs (serving
every dense architecture, engine and oracle rows equal, seal and validate,
a flipped byte refused with code 2, a Chrome trace, the front door with
SLA preemption, training that resumes from its checkpoint and serving from
it). Without ``--device cpu`` and without a GPU both raise, never running
on the CPU; for whisper both exit before building a weight."""
import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.serving import artifact as tart  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DENSE = ("stablelm-3b", "stablelm-12b", "qwen2-7b", "gemma2-27b")
SMALL = ["--smoke", "--device", "cpu", "--prompt-len", "8",
         "--new-tokens", "6", "--batch", "3"]


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch, module):
    """The parser the reference launcher builds inside its ``main``,
    caught at its ``parse_args`` call."""
    def catch(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        module.main()
    monkeypatch.undo()
    return e.value.args[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.const, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["serve", "train"])
def test_parser_matches_reference(name, monkeypatch):
    import importlib
    ref = importlib.import_module(f"repro.launch.{name}")
    port = {"serve": serve, "train": train}[name]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    helps = [subprocess.run([sys.executable, "-m", mod, "--help"], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True).stdout
             for mod in (f"repro.launch.{name}", f"repro_torch.launch.{name}")]
    flags = [set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", h))
             for h in helps]
    assert flags[1] == flags[0] | {"--device"}
    want = _options(_reference_parser(monkeypatch, ref))
    got = _options(port.build_parser())
    dev = got.pop("device")
    assert dev[:2] == (("--device",), "cuda") and dev[3] == ("cuda", "cpu")
    assert got == want


def _reference_prune(cfg, params, sparsity, packed):
    """The reference launcher's one-shot prune and export
    (``repro/launch/serve.py``, no checkpoint), as it is written there."""
    from repro.core.prune_grow import initial_mask
    sm, registry, export = jsm, jreg, jexport
    spec = dataclasses.replace(cfg.blast, s_init=sparsity, s_max=sparsity)
    masks = {}
    for path in registry.sparse_paths(cfg):
        w = sm.get_path(params, path)
        bi, bo = sm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        fn = lambda wi: initial_mask(pspec, wi)  # noqa: E731
        for _ in range(w.ndim - 2):
            fn = jax.vmap(fn)
        masks[path] = fn(w)
    out = (export.pack_params(cfg, params, masks) if packed
           else export.prune_params(cfg, params, masks))
    return masks, out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("arch", DENSE)
def test_prune_and_pack_matches_reference_launcher(arch, packed):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    jmasks, want = jax.device_get(_reference_prune(jcfg, params, 0.7,
                                                   packed))
    tparams = interop.to_torch(jax.device_get(params), device="cpu")
    tmasks = serve.one_shot_masks(tcfg, tparams, 0.7)
    assert sorted(tmasks) == sorted(jmasks)
    for path, m in jmasks.items():
        np.testing.assert_array_equal(tmasks[path].numpy(), np.asarray(m))
    got = interop.to_numpy(serve.prune_and_pack(tcfg, tparams, 0.7, packed))
    flat_w, flat_g = (dict(_flat(t)) for t in (want, got))
    assert sorted(flat_w) == sorted(flat_g)
    for k, w in flat_w.items():
        np.testing.assert_array_equal(_bits(flat_g[k]), _bits(w), err_msg=k)


def _flat(tree, prefix=""):
    """(path, array) pairs; a packed leaf (the reference's object or the
    port's dict) gives its blocks, idx, kb and joint."""
    if hasattr(tree, "blocks"):
        tree = {k: getattr(tree, k) for k in ("blocks", "idx", "kb", "joint")}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)


def _rows(out: str) -> list[str]:
    return out.strip().splitlines()[-2:]


@pytest.mark.parametrize("arch", DENSE)
def test_serve_engine_and_oracle_rows_equal(arch, capsys):
    res = serve.main(["--arch", arch, "--packed", *SMALL])
    out = capsys.readouterr().out
    assert "serving memory:" in out and res["memory"]["bytes"] > 0
    assert len(res["tokens"]) == 3 and res["stats"]["generated_tokens"] == 18
    serve.main(["--arch", arch, "--packed", "--oracle", *SMALL])
    oracle = capsys.readouterr().out
    rows = _rows(out)
    assert rows == _rows(oracle)
    assert rows == [" ".join(map(str, t)) for t in res["tokens"][:2]]


def test_seal_validate_and_a_flipped_byte(tmp_path, capsys):
    d = str(tmp_path / "art")
    assert serve.main(["--arch", "stablelm-3b", "--packed", "--seal", d,
                       *SMALL]) is None
    assert serve.main(["--arch", "stablelm-3b", "--artifact", d,
                       "--validate-only", *SMALL]) is None
    assert "artifact OK" in capsys.readouterr().out
    path = os.path.join(d, "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "stablelm-3b", "--artifact", d,
                    "--validate-only", *SMALL])
    assert e.value.code == 2
    name = re.search(r"artifact INVALID \((\w+)\)",
                     capsys.readouterr().out).group(1)
    assert issubclass(getattr(tart, name), tart.ArtifactError)


def test_trace_out_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    serve.main(["--arch", "qwen2-7b", "--packed", "--trace-out", path,
                *SMALL])
    events = json.load(open(path))["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"prefill.chunks", "decode.slab"} <= names


def test_frontdoor_sla_preempt_completes(capsys):
    res = serve.main(["--arch", "gemma2-27b", "--packed", "--frontdoor",
                      "--sla", "--preempt", "--smoke", "--device", "cpu",
                      "--batch", "3", "--max-batch", "2", "--prompt-len",
                      "16", "--new-tokens", "12", "--n-inter", "2",
                      "--inter-tokens", "4", "--inter-gap-s", "0.05"])
    out = capsys.readouterr().out
    assert re.search(r"interactive: n=2 ", out)
    assert re.search(r"batch: n=3 ", out)
    assert res["stats"]["generated_tokens"] == 3 * 12 + 2 * 4


def test_train_resumes_and_serve_restores_the_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    base = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", d]
    state, _ = train.main(base + ["--steps", "10"])
    assert state.step == 10
    assert "[resume]" not in capsys.readouterr().out
    state, hist = train.main(base + ["--steps", "12"])
    out = capsys.readouterr().out
    assert f"[resume] restored step 10 from {d}" in out
    assert state.step == 12 and hist[-1]["step"] == 11
    state, hist = train.main(base + ["--steps", "10"])   # saved at 10 only
    assert state.step == 10 and not hist
    assert "nothing to train past step 10" in capsys.readouterr().out
    res = serve.main(["--arch", "stablelm-3b", "--packed", "--ckpt-dir", d,
                      *SMALL])
    assert res["stats"]["generated_tokens"] == 18


@pytest.mark.parametrize("argv", [["--mesh", "single"], ["--mesh", "multi"],
                                  ["--devices", "2"]])
def test_train_multi_device_exits_non_zero(argv, monkeypatch):
    from repro_torch.training import train_loop
    monkeypatch.setattr(train_loop, "train", _never)
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                    *argv])
    assert e.value.code not in (0, None)
    assert "multi-device" in str(e.value.code)


def _never(*a, **k):
    raise AssertionError("ran without a CUDA device")


def test_default_device_without_a_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models import registry
    from repro_torch.training import train_loop
    monkeypatch.setattr(registry, "init_params", _never)
    monkeypatch.setattr(train_loop, "train", _never)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "stablelm-3b", "--smoke", "--packed"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "stablelm-3b", "--smoke", "--steps", "2"])


@pytest.mark.parametrize("mod", [serve, train], ids=["serve", "train"])
def test_families_not_ported_raise(mod, monkeypatch):
    """Neither launcher makes whisper's encoder frames: ``serve`` points
    at ``serve_loop.generate(frames=...)`` and ``train`` names the
    ``frames`` its token sources lack, each before any weight is built
    (the reference builds the model, then fails on the missing frames)."""
    from repro_torch.models import registry
    from repro_torch.training import train_loop
    monkeypatch.setattr(registry, "init_params", _never)
    monkeypatch.setattr(train_loop, "train", _never)
    with pytest.raises(SystemExit) as e:
        mod.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                  "cpu"])
    msg = str(e.value.code)
    assert "'audio'" in msg
    assert ("serve_loop.generate(frames=...)" if mod is serve
            else "'frames'") in msg
