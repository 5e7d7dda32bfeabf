"""Fault-tolerant checkpointing (port of
``repro/checkpointing/checkpoint.py``): numpy ``.npz`` files and atomic
renames, in the reference's layout, so either package reads what the
other wrote.

  * checkpoints are stored logically (whole arrays, path-keyed npz);
  * atomic and non-destructive: write ``<dir>.tmp``, park any existing
    ``<dir>`` at ``<dir>.old``, rename the tmp into place, then drop the
    ``.old``; at no instant is the previous intact checkpoint deleted
    before its replacement is in place. A killed writer's leftovers are
    recovered on the next start: a parked ``.old`` whose final rename
    never happened is promoted back, a stale ``.tmp`` is dropped, and
    ``steps()`` lists neither;
  * integrity: every array is crc32'd into a manifest in ``meta.json``
    and verified on restore, as it is read (one pass over the file);
    ``restore(step=None)`` falls back to the newest intact checkpoint
    (counting ``fallbacks``), and keep-k GC never deletes the newest
    intact one, even when newer ones are corrupt;
  * async: the device-to-host gather runs in the caller (the next
    training step must not race it; one device sync covers the whole
    tree), the file write in a background thread; a failed write is
    re-raised on ``wait()`` or the next ``save()``. A save joins the
    previous write before it gathers, so one host copy of the state is
    alive at a time; gathered from the GPU it is pinned memory, which
    PyTorch's host allocator keeps cached for the next save;
  * the step and the ``torch.Generator``'s state (``rng``, its
    ``get_state()`` bytes) are inside the checkpoint, so a restart
    replays the exact batch sequence.

numpy has no bfloat16: such a leaf is stored as its 16-bit pattern
(``uint16``) and ``meta.json`` records its dtype under ``dtypes``. The
reference reads only ``checksums`` and ``step`` there.

Multi-device (the sharded train step): checkpoints stay logical. The
train loop gathers the state (``sharding.gather_state``) and one rank,
the ``writer``, saves it: the same files as one device's save of that
state. ``restore(shardings=)`` / ``restore_state(shardings=)`` cut each
logical array to this rank's block of whatever mesh the shardings name
(``sharding.NamedSharding``), so a run restarts on another mesh
(elastic restart). A ``Checkpointer(writer=False)`` (every other rank)
reads only: it leaves a killed writer's leftovers to the writer.

``tracer`` (obs/trace.py; the train loop installs its own) records a
``ckpt.save`` span over the part of a save that holds up training (the
join, the gather and a blocking write), a ``ckpt.restore`` span and a
``ckpt.fallback`` event for each restore that skipped corrupt
checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.training.faults import CheckpointCorruptionError


def flatten_tree(tree, prefix=""):
    """Nested dict/list tree -> flat ``{"a/b/0": leaf}`` dict. Shared with
    serving/artifact.py, which splits packed leaves on top."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten_tree(template, flat):
    def rec(node, prefix):
        if isinstance(node, dict):
            return {k: rec(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [rec(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return type(node)(vals)
        return flat[prefix.rstrip("/")]
    return rec(template, "")


def crc32_array(a: np.ndarray) -> int:
    """The integrity primitive shared by checkpoints, the host KV offload
    store and sealed serving artifacts: crc32 of the array's bytes (read
    in place, no copy, for a C-contiguous array)."""
    a = np.ascontiguousarray(a)
    return zlib.crc32(a.reshape(-1).view(np.uint8))


def encode_leaf(a) -> tuple[np.ndarray, str]:
    """A host tensor, numpy array or Python scalar -> (an array npz can
    store, the leaf's true dtype). numpy has no bfloat16: such a leaf is
    stored as its 16-bit pattern (``uint16``). Shared with
    serving/artifact.py and the artifact fault injectors."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def decode_leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """``encode_leaf``'s inverse: a stored array (freshly read, so
    writable) -> a host tensor of its true dtype, sharing its memory."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.ascontiguousarray(arr))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start one tensor's copy to host memory. From the GPU the copy is
    asynchronous into pinned memory: read it only after a device sync."""
    t = t.detach()
    if t.device.type == "cpu":
        return t
    return t.to("cpu", non_blocking=True)


def host_arrays(flat: dict) -> tuple[dict, dict]:
    """Flat leaves (tensors, generators, numpy arrays, Python scalars) ->
    (numpy arrays, {key: "bfloat16"} for leaves stored as ``uint16``).
    Every device copy is queued first, then one device sync covers them
    all."""
    staged = {}
    for k, v in flat.items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        staged[k] = to_host(v) if isinstance(v, torch.Tensor) else v
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    host, dtypes = {}, {}
    for k, v in staged.items():
        host[k], dt = encode_leaf(v)
        if dt == "bfloat16":
            dtypes[k] = dt
    return host, dtypes


def _leaf_like(tmpl, arr: np.ndarray, dtype: str | None, device):
    """One stored array -> a leaf of the template's kind: a tensor (on
    ``device``, else the template's), a ``torch.Generator`` with the
    stored state, a Python int, or the numpy array."""
    if isinstance(tmpl, torch.Generator):
        dev = torch.device(device) if device is not None else tmpl.device
        g = torch.Generator(device=dev)
        g.set_state(torch.from_numpy(np.ascontiguousarray(arr)))
        return g
    if isinstance(tmpl, torch.Tensor):
        t = decode_leaf(arr, dtype or str(arr.dtype))
        return t.to(device if device is not None else tmpl.device)
    if isinstance(tmpl, int) and not isinstance(tmpl, bool):
        return int(arr)
    return decode_leaf(arr, dtype) if dtype == "bfloat16" else arr


def _state_tree(state) -> dict:
    return {"step": np.asarray(state.step, np.int32),
            "params": state.params, "opt_state": state.opt_state,
            "masks": state.masks, "rng": state.generator}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.dir = directory
        self.writer = writer
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.fallbacks = 0         # corrupt or torn checkpoints skipped
        self.fault_hook = None     # training/faults.py corruption port
        self.tracer = NULL_TRACER  # obs/trace.py; train_loop installs
        os.makedirs(directory, exist_ok=True)
        if writer:
            self._recover_leftovers()

    def _recover_leftovers(self):
        """Crash cleanup: a parked ``.old`` whose final rename never
        happened (the swap's crash window) is promoted back; it was intact
        when parked. Stale ``.tmp`` dirs of a killed writer are dropped."""
        for name in sorted(os.listdir(self.dir)):
            p = os.path.join(self.dir, name)
            if name.endswith(".old"):
                final = p[: -len(".old")]
                if os.path.exists(final):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    os.replace(p, final)
            elif name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # ----------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = False,
             extra: dict | None = None):
        """Gather to host synchronously, write asynchronously (or here,
        with ``blocking``). The previous async write is joined first and
        its exception raised here, before the gather (the reference
        gathers first, holding two host copies while a write runs).
        ``state`` is a ``TrainState`` or any nested dict of tensors and
        arrays."""
        from repro_torch.training.step import TrainState
        if not self.writer:
            raise RuntimeError(f"this Checkpointer of {self.dir} only "
                               "reads (writer=False)")
        t_save = time.monotonic()
        tree = _state_tree(state) if isinstance(state, TrainState) else state
        self.wait()
        host, dtypes = host_arrays(flatten_tree(tree))

        def write():
            tmp, final = self._path(step) + ".tmp", self._path(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            meta = {"step": int(step),
                    "checksums": {k: crc32_array(a)
                                  for k, a in host.items()},
                    **({"dtypes": dtypes} if dtypes else {}),
                    **(extra or {})}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                # non-destructive swap: park, rename in, then drop
                old = final + ".old"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
            if self.fault_hook is not None:
                self.fault_hook(final, step)
            self._gc()

        if blocking:
            write()
        else:
            def runner():
                try:
                    write()
                except BaseException as e:   # surfaced on wait()/save()
                    self._error = e
            self._thread = threading.Thread(target=runner, daemon=True)
            self._thread.start()
        if self.tracer.enabled:
            # the part that holds up training: the join, the gather and,
            # blocking, the write
            self.tracer.span_at("ckpt.save", t_save, time.monotonic(),
                                step=int(step), blocking=blocking)

    def wait(self):
        """Join any in-flight write and re-raise its exception."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        """Keep-k retention that never deletes the newest intact
        checkpoint: when newer ones are corrupt, the newest one that
        verifies is kept even outside keep-k."""
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        protect = set(steps[-self.keep:])
        for s in reversed(steps):
            if self.verify(s):
                protect.add(s)
                break
        for s in steps:
            if s not in protect:
                shutil.rmtree(self._path(s), ignore_errors=True)

    # -------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and not name.endswith(".old")):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def verify(self, step: int) -> bool:
        """Full integrity check: meta.json parses, the array set matches
        the manifest, and every array's crc32 matches. A checkpoint
        without a manifest passes on a load test alone."""
        return self._intact(step)

    def _intact(self, step: int, take=None) -> bool:
        """``verify``'s check in one pass over the arrays: each is read
        once, its crc32 checked, and then handed to ``take(name, array,
        meta)`` (a restore's load). A read error means not intact; an
        error in ``take`` propagates."""
        d = self._path(step)
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            cks = meta.get("checksums")
            z = np.load(os.path.join(d, "arrays.npz"))
        except Exception:
            return False
        with z:
            try:
                names = list(z.files)
                if cks is not None and set(names) != set(cks):
                    return False
            except Exception:
                return False
            for k in names:
                try:
                    a = z[k]
                    ok = cks is None or crc32_array(a) == cks[k]
                except Exception:
                    return False
                if not ok:
                    return False
                if take is not None:
                    take(k, a, meta)
        return True

    def latest_intact_step(self) -> int | None:
        for s in reversed(self.steps()):
            if self.verify(s):
                return s
        return None

    def _load(self, template, step: int, device, shardings):
        """Checkpoint ``step`` restored into ``template``'s structure,
        verified as it is read (``_intact``: one pass over the file), or
        None when it is not intact."""
        tmpl = flatten_tree(template)
        shd = flatten_tree(shardings) if shardings is not None else {}
        flat = {}

        def take(k, a, meta):
            if k in tmpl:
                leaf = _leaf_like(tmpl[k], a, meta.get("dtypes", {}).get(k),
                                  device)
                if shd.get(k) is not None:
                    leaf = shd[k].shard(leaf)
                flat[k] = leaf

        if not self._intact(step, take):
            return None
        return unflatten_tree(template, flat)

    def restore(self, template, step: int | None = None, device=None,
                shardings=None):
        """Restore into the structure of ``template``: a tensor leaf comes
        back as a tensor on ``device`` (default: the template leaf's), a
        generator leaf as a generator with the saved state, an int as an
        int, anything else as the stored numpy array. With ``shardings``
        (a tree of ``sharding.NamedSharding`` over the template's paths;
        a missing or None entry keeps its leaf whole) each array comes
        back as this rank's block on their mesh (elastic reshard).

        An explicit ``step`` is verified and raises
        ``CheckpointCorruptionError`` on a mismatch. With ``step=None``
        the newest intact checkpoint is restored; corrupt or torn newer
        ones are skipped (counted in ``fallbacks``, each skip a
        ``ckpt.fallback`` event inside the ``ckpt.restore`` span)."""
        with self.tracer.span("ckpt.restore",
                              step=-1 if step is None else int(step)):
            if step is not None:
                out = self._load(template, step, device, shardings)
                if out is None:
                    raise CheckpointCorruptionError(step, self.dir)
                return out
            steps = self.steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            for skipped, s in enumerate(reversed(steps)):
                out = self._load(template, s, device, shardings)
                if out is not None:
                    if skipped:
                        self.tracer.event("ckpt.fallback",
                                          skipped=skipped, to_step=s)
                    self.fallbacks += skipped
                    return out
            raise CheckpointCorruptionError(
                steps[-1], self.dir, "no intact checkpoint to fall back to")

    def restore_state(self, template_state, step: int | None = None,
                      device=None, shardings=None):
        """Restore a ``TrainState`` (the template gives structure, dtypes
        and, without ``device``, each leaf's device). ``shardings``: a
        ``TrainState`` of ``NamedSharding`` trees
        (``sharding.state_shardings``; the optimizer's buffers follow the
        params) restores this rank's shard."""
        from repro_torch.training.step import TrainState
        tmpl = {"step": int(template_state.step),
                "params": template_state.params,
                "opt_state": template_state.opt_state,
                "masks": template_state.masks,
                "rng": template_state.generator}
        shd = None
        if shardings is not None:
            shd = {"params": shardings.params,
                   "opt_state": {k: shardings.params
                                 for k in template_state.opt_state},
                   "masks": shardings.masks}
        tree = self.restore(tmpl, step, device, shd)
        return TrainState(step=tree["step"], params=tree["params"],
                          opt_state=tree["opt_state"], masks=tree["masks"],
                          generator=tree["rng"])
