"""The PyTorch port stands alone: importing every module of
``src/repro_torch`` loads neither JAX nor any module of the JAX package,
no file of it (nor ``chip_smoke.py``, which drives it on the card) names
them in an import, and its entry points default to the GPU."""
import ast
import inspect
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
FILES = sorted(str(p.relative_to(SRC)) for p in PKG.rglob("*.py"))


def _module(rel: str) -> str:
    mod = rel[:-3].replace("/", ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def test_importing_every_module_loads_no_jax():
    mods = [_module(f) for f in FILES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("rel", FILES + ["../chip_smoke.py"])
def test_no_file_imports_jax_or_repro(rel):
    tree = ast.parse((SRC / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{rel} imports {bad}"


def test_multi_device_modules_are_scanned():
    """The multi-device slices' modules are among the files above."""
    for rel in ("repro_torch/distributed/context.py",
                "repro_torch/distributed/sharding.py",
                "repro_torch/launch/mesh.py",
                "repro_torch/training/deferred.py",
                "repro_torch/optim/compress.py"):
        assert rel in FILES


def test_entry_points_default_to_the_gpu():
    from repro_torch.models import registry, transformer
    from repro_torch.models.params import init_params
    from repro_torch.serving import artifact, engine, serve_loop
    from repro_torch.training import faults, step, train_loop
    for fn in (engine.Engine.__init__, engine.generate, registry.init_params,
               init_params, transformer.init_paged_cache,
               transformer.init_cache, serve_loop.generate,
               serve_loop.prefill_with_decode, step.init_state,
               train_loop.train, artifact.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert faults.default_chaos_spec("/nonexistent")["device"] == "cuda"
