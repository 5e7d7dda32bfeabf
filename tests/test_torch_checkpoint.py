"""The port's ``Checkpointer`` (``repro_torch/checkpointing``) through
every case of the reference's ``tests/test_checkpoint.py``: round trip,
keep-k, latest discovery, async writes and their failures, the crc32
manifest, corrupt and torn fallbacks, crash-window recovery and legacy
manifests. Then the two packages read each other's checkpoints: one the
JAX ``Checkpointer`` wrote verifies in the port and restores equal
through ``interop`` (and its layout and crc32s equal what the port writes
for the same state); one the port wrote verifies and restores in the JAX
package; a bfloat16 leaf round-trips bitwise. Bytes, crc32s, masks and
steps are held bitwise; there is no float tolerance here."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.checkpointing import checkpoint as jckpt  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpointing import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpointing.checkpoint import (Checkpointer,  # noqa: E402
                                                  crc32_array)
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import step as tts  # noqa: E402
from repro_torch.training.faults import CheckpointCorruptionError  # noqa: E402
from test_torch_train import port_cfg  # noqa: E402


def _state():
    return tts.init_state(port_cfg(tiny_cfg()), 0, "cpu")


def _tree(s):
    return {"p": s.params, "o": s.opt_state, "m": s.masks}


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(tadam.tree_leaves(_tree(a)), tadam.tree_leaves(_tree(b))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_roundtrip(tmp_path):
    state = _state()
    state.generator.manual_seed(1234)
    torch.randn(3, generator=state.generator)     # move the generator on
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, state, blocking=True)
    template = tts.init_state(port_cfg(tiny_cfg()), 5, "cpu")
    restored = ck.restore_state(template)
    _assert_states_equal(restored, state)
    # the restored generator continues where the saved one stood
    assert torch.equal(torch.randn(4, generator=restored.generator),
                       torch.randn(4, generator=state.generator))


def test_keep_k_and_latest(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state, blocking=True)
    assert ck.steps() == [3, 4]
    assert ck.latest_step() == 4


def test_no_tmp_left_behind(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(7, _state(), blocking=True)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _state(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 5


def _dict_state(step, seed=0):
    r = np.random.default_rng(seed)
    return {"step": np.int32(step),
            "w": r.standard_normal((8, 8)).astype(np.float32),
            "b": r.standard_normal(8).astype(np.float32)}


def _bitflip(d, step):
    f = os.path.join(d, f"step_{step:08d}", "arrays.npz")
    with open(f, "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        off = fh.tell() // 2
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 1]))


def test_save_joins_the_previous_write_before_gathering(tmp_path,
                                                       monkeypatch):
    """One host copy of the state at a time: a save's gather starts only
    once the previous background write has ended (each write is slowed so
    that a save made right after it would otherwise overlap it)."""
    ck = Checkpointer(str(tmp_path))
    real_savez, real_host = np.savez, tckpt.host_arrays
    overlapped = []

    def slow_savez(*a, **kw):
        time.sleep(0.3)
        real_savez(*a, **kw)

    def host(flat):
        overlapped.append(ck._thread is not None and ck._thread.is_alive())
        return real_host(flat)

    monkeypatch.setattr(np, "savez", slow_savez)
    monkeypatch.setattr(tckpt, "host_arrays", host)
    for step in (1, 2, 3):
        ck.save(step, _dict_state(step))
    ck.wait()
    assert overlapped == [False, False, False]
    assert all(ck.verify(s) for s in (1, 2, 3))


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    """A background write that dies re-raises on wait() and on the next
    save(), once."""
    ck = Checkpointer(str(tmp_path))
    boom = RuntimeError("disk full")

    def bad_savez(*a, **kw):
        raise boom

    monkeypatch.setattr(np, "savez", bad_savez)
    ck.save(1, _dict_state(1), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait()
    ck.wait()                 # cleared after being raised once
    ck.save(2, _dict_state(2), blocking=False)
    ck._thread.join()         # the error is captured before unpatching
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="disk full"):
        ck.save(3, _dict_state(3), blocking=True)
    ck.save(4, _dict_state(4), blocking=True)
    assert ck.latest_intact_step() == 4


def test_crc_bitflip_detected_and_fallback(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    for s in (1, 2, 3):
        ck.save(s, _dict_state(s, seed=s), blocking=True)
    _bitflip(str(tmp_path), 3)
    assert not ck.verify(3)
    assert ck.verify(2)
    with pytest.raises(CheckpointCorruptionError):
        ck.restore(_dict_state(0), step=3)
    got = ck.restore(_dict_state(0))
    assert int(got["step"]) == 2
    assert ck.fallbacks == 1
    np.testing.assert_array_equal(got["w"], _dict_state(2, seed=2)["w"])


def test_torn_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _dict_state(1), blocking=True)
    torn = tmp_path / "step_00000005"
    torn.mkdir()
    (torn / "meta.json").write_text("{not json")
    assert ck.steps() == [1, 5]
    assert not ck.verify(5)
    assert ck.latest_intact_step() == 1
    assert int(ck.restore(_dict_state(0))["step"]) == 1


def test_leftover_tmp_and_old_recovered(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(4, _dict_state(4), blocking=True)
    final = tmp_path / "step_00000004"
    os.replace(final, str(final) + ".old")
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "junk").write_text("x")
    ck2 = Checkpointer(str(tmp_path))
    assert ck2.steps() == [4]
    assert ck2.verify(4)
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert not (tmp_path / "step_00000004.old").exists()


def test_gc_never_deletes_newest_intact(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)

    def hook(path, step):
        if step in (3, 4):
            _bitflip(str(tmp_path), step)

    ck.fault_hook = hook
    for s in (1, 2, 3, 4):
        ck.save(s, _dict_state(s, seed=s), blocking=True)
    assert 2 in ck.steps()
    assert ck.latest_intact_step() == 2
    assert int(ck.restore(_dict_state(0))["step"]) == 2


def test_no_intact_checkpoint_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _dict_state(1), blocking=True)
    _bitflip(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptionError, match="no intact"):
        ck.restore(_dict_state(0))


def test_overwrite_same_step_has_no_crash_window(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck = Checkpointer(d)
    ck.save(5, _dict_state(5, seed=1), blocking=True)
    orig = dict(np.load(os.path.join(d, "step_00000005", "arrays.npz")))
    real_replace = os.replace

    def crashy_replace(src, dst):
        if src.endswith(".tmp"):
            raise KeyboardInterrupt("killed mid-swap")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", crashy_replace)
    with pytest.raises(KeyboardInterrupt):
        ck.save(5, _dict_state(5, seed=2), blocking=True)
    monkeypatch.undo()
    ck2 = Checkpointer(d)
    assert ck2.verify(5)
    np.testing.assert_array_equal(ck2.restore(_dict_state(0))["w"],
                                  orig["w"])


def test_legacy_checkpoint_without_manifest_restores(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _dict_state(3), blocking=True)
    with open(os.path.join(str(tmp_path), "step_00000003", "meta.json"),
              "w") as f:
        json.dump({"step": 3}, f)
    assert ck.verify(3)
    assert int(ck.restore(_dict_state(0))["step"]) == 3


# ---------------------------------------------------- cross-package reads
@pytest.fixture(scope="module")
def jstate():
    return jax.device_get(jts.init_state(tiny_cfg(), jax.random.PRNGKey(0)))


def _meta(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def test_jax_checkpoint_verifies_and_restores_in_port(jstate, tmp_path):
    """The JAX Checkpointer's file passes the port's verify, and params,
    opt_state, masks and step restore bitwise equal (through interop).
    The port writing the same state gives the same array names and the
    same crc32 for every leaf but the generator's."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.Checkpointer(jd).save(3, jstate, blocking=True)
    ck = Checkpointer(jd)
    assert ck.verify(3) and ck.latest_intact_step() == 3
    want = interop.train_state(jstate, device="cpu")
    tmpl = {"step": 0, "params": want.params, "opt_state": want.opt_state,
            "masks": want.masks}
    got = ck.restore(tmpl)
    assert got["step"] == int(np.asarray(jstate.step))
    for x, y in zip(tadam.tree_leaves(got), tadam.tree_leaves(
            {k: tmpl[k] for k in ("params", "opt_state", "masks")})):
        assert x.dtype == y.dtype and torch.equal(x, y)
    Checkpointer(td).save(3, want, blocking=True)
    jm, tm = _meta(jd, 3)["checksums"], _meta(td, 3)["checksums"]
    assert set(jm) == set(tm)
    assert {k: v for k, v in tm.items() if k != "rng"} == \
        {k: v for k, v in jm.items() if k != "rng"}


def test_port_checkpoint_verifies_and_restores_in_jax(jstate, tmp_path):
    d = str(tmp_path)
    state = interop.train_state(jstate, device="cpu")
    Checkpointer(d).save(6, state, blocking=True)
    jck = jckpt.Checkpointer(d)
    assert jck.verify(6) and jck.latest_intact_step() == 6
    tmpl = {"step": jstate.step, "params": jstate.params,
            "opt_state": jstate.opt_state, "masks": jstate.masks}
    got = jck.restore(tmpl)
    assert int(got["step"]) == 0
    np.testing.assert_equal(
        jax.tree_util.tree_map(np.asarray, {k: got[k] for k in tmpl
                                            if k != "step"}),
        interop.to_numpy({"params": state.params,
                          "opt_state": state.opt_state,
                          "masks": state.masks}))


def test_bf16_leaf_roundtrips_bitwise(tmp_path):
    """A bfloat16 leaf is stored as its 16-bit pattern with its dtype in
    meta.json; the crc32 is over those bits, and the JAX package
    verifies the file."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    w[0, 0] = float("nan")
    tree = {"w": w, "f": torch.arange(4.0)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    meta = _meta(str(tmp_path), 1)
    assert meta["dtypes"] == {"w": "bfloat16"}
    bits = w.view(torch.int16).numpy().view(np.uint16)
    assert meta["checksums"]["w"] == crc32_array(bits)
    assert jckpt.Checkpointer(str(tmp_path)).verify(1)
    got = ck.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                      "f": torch.zeros(4)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(got["f"], tree["f"])
