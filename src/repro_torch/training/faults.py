"""Deterministic fault injection for training and the training stack's
failure taxonomy (port of ``repro/training/faults.py``).

A ``TrainFaultPlan`` is consumed at fixed host step indices, so chaos
tests replay bitwise. Fault points, keyed by the loop's step index ``i``
(one ``step_fn`` call):

  * ``nan_grads(step)``      — multiply the loss by ``(1 + NaN/Inf)``
    before the backward, poisoning every gradient; the step's anomaly
    guard must skip the update (0.0 is an exact identity);
  * ``loss_spike(step, m)``  — add ``m`` to the reported loss only; the
    host-side EMA/z-score detector must flag it;
  * ``force_skip(step)``     — force the skip path with healthy
    gradients ("a run that never applies step k's update");
  * ``hard_kill(step)``      — SIGKILL our own process at the top of the
    step; a resume must end bitwise where an uninterrupted run ends;
  * ``slow_step(step, s)``   — sleep inside the timed region, for the
    straggler watchdog;
  * ``corrupt_checkpoint(nth_save)`` — flip one bit of the nth
    checkpoint's array file after it landed (post-rename, post-checksum):
    restore must detect it and fall back to the newest intact one.

The module also holds the subprocess chaos child (``python -m
repro_torch.training.faults spec.json``): a training run built from a
JSON spec that tests and ``chip_smoke.py`` SIGKILL, resume and compare
bitwise against an uninterrupted run. The child switches PyTorch to its
deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG=:4096:8``) before
CUDA starts, and records any op that has no deterministic variant. With
a ``trace_dir`` in its spec the child trains under a ``Tracer`` whose
postmortems land there, and its metadata summarises the ring (records by
name, ``train.step`` durations, each postmortem's reason, meta and record
count).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np


# --------------------------------------------------------------- errors
class TrainingFault(Exception):
    """Base class for every structured training-stack failure."""


class CheckpointCorruptionError(TrainingFault):
    """A checkpoint failed integrity verification (crc32 manifest
    mismatch, torn directory, unreadable arrays)."""

    def __init__(self, step: int | None, directory: str,
                 reason: str = "checksum mismatch"):
        self.step, self.directory, self.reason = step, directory, reason
        super().__init__(
            f"checkpoint step {step} in {directory} failed integrity "
            f"verification: {reason}")


class TrainingDivergedError(TrainingFault):
    """K consecutive anomalous steps and the rewind budget is spent (or
    no intact checkpoint exists to rewind to): replaying will not help."""

    def __init__(self, step: int, consecutive: int, rewinds: int):
        self.step, self.consecutive, self.rewinds = (step, consecutive,
                                                     rewinds)
        super().__init__(
            f"training diverged at step {step}: {consecutive} "
            f"consecutive anomalous steps after {rewinds} rewind(s)")


# ------------------------------------------------------------- the plan
class TrainFaultPlan:
    """A seeded, replayable schedule of injected training faults.

    Arm faults at step indices and hand the plan to
    ``train_loop.train(..., faults=plan)``. The plan is consumed as it
    fires: a rewind replays the faulted steps cleanly, and a rerun needs
    a fresh plan. ``rng`` (from ``seed``) is for tests that draw their
    fault steps; the plan never draws from it itself. ``fired`` is the
    audit trail."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._nan: dict[int, str] = {}          # step -> "nan" | "inf"
        self._spikes: dict[int, float] = {}     # step -> magnitude
        self._skips: set[int] = set()
        self._kills: set[int] = set()
        self._slow: dict[int, float] = {}       # step -> seconds
        self._corrupt_saves: dict[int, int] = {}  # nth save -> bit
        self._n_saves = 0
        self.fired: list[str] = []

    # ----------------------------------------------------------- arming
    def nan_grads(self, step: int, kind: str = "nan") -> "TrainFaultPlan":
        if kind not in ("nan", "inf"):
            raise ValueError(f"poison kind {kind!r} is not nan or inf")
        self._nan[step] = kind
        return self

    def loss_spike(self, step: int,
                   magnitude: float = 1e3) -> "TrainFaultPlan":
        self._spikes[step] = float(magnitude)
        return self

    def force_skip(self, step: int) -> "TrainFaultPlan":
        self._skips.add(step)
        return self

    def hard_kill(self, step: int) -> "TrainFaultPlan":
        self._kills.add(step)
        return self

    def slow_step(self, step: int, seconds: float) -> "TrainFaultPlan":
        self._slow[step] = float(seconds)
        return self

    def corrupt_checkpoint(self, nth_save: int = 0,
                           bit: int = 0) -> "TrainFaultPlan":
        self._corrupt_saves[nth_save] = bit
        return self

    # ------------------------------------------------------- loop hooks
    def step_scalars(self, idx: int) -> dict:
        """The step's injection scalars (all three keys every step; the
        no-fault values are exact identities inside the step)."""
        gp = 0.0
        if idx in self._nan:
            kind = self._nan.pop(idx)
            gp = np.nan if kind == "nan" else np.inf
            self.fired.append(f"nan_grads:{kind}@{idx}")
        lp = 0.0
        if idx in self._spikes:
            lp = self._spikes.pop(idx)
            self.fired.append(f"loss_spike@{idx}:{lp:g}")
        fs = 0.0
        if idx in self._skips:
            self._skips.discard(idx)
            fs = 1.0
            self.fired.append(f"force_skip@{idx}")
        return {"grad_poison": np.float32(gp),
                "loss_poison": np.float32(lp),
                "force_skip": np.float32(fs)}

    def on_host_step(self, idx: int) -> None:
        """Top of the loop iteration: the hard process kill (nothing
        after it runs, an in-flight async checkpoint write included)."""
        if idx in self._kills:
            self._kills.discard(idx)
            os.kill(os.getpid(), signal.SIGKILL)

    def on_timed_step(self, idx: int) -> None:
        """Inside the timed region, before the step: a slow step."""
        s = self._slow.pop(idx, None)
        if s:
            self.fired.append(f"slow@{idx}:{s:g}s")
            time.sleep(s)

    def on_ckpt_saved(self, path: str, step: int) -> None:
        """Checkpointer hook, called after the directory was renamed into
        place (checksums already computed): flip one bit of the byte in
        the middle of the array file."""
        nth = self._n_saves
        self._n_saves += 1
        bit = self._corrupt_saves.pop(nth, None)
        if bit is None:
            return
        f = os.path.join(path, "arrays.npz")
        with open(f, "r+b") as fh:
            fh.seek(0, os.SEEK_END)
            off = fh.tell() // 2
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ (1 << (bit % 8))]))
        self.fired.append(f"ckpt_bitflip:save{nth}@step{step}")


# ----------------------------------------------- subprocess chaos child
def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_chaos_spec(workdir: str, **overrides) -> dict:
    """The tiny training spec the chaos harness kills and resumes (the
    reference's). ``step_size=5`` with ``kill_at=11`` and
    ``ckpt_every=4`` puts the resumed replay across a prune-and-grow
    refresh (restore at step 8, refresh at step 10). ``device`` is where
    the child trains."""
    spec = {
        "model": dict(name="chaos-tiny", family="dense", num_layers=2,
                      d_model=32, num_heads=2, num_kv_heads=2,
                      head_dim=16, d_ff=64, vocab_size=64,
                      mlp_kind="glu", mlp_act="silu",
                      norm_kind="rmsnorm", remat=False,
                      compute_dtype="float32", chunk_size=8),
        "blast": dict(enabled=True, b_in=16, b_out=16, s_max=0.75,
                      total_steps=20, step_size=5, dense_last=1),
        "steps": 16, "seq_len": 32, "batch": 8, "data_seed": 3,
        "opt": dict(peak_lr=2e-2, warmup_steps=5, total_steps=60,
                    weight_decay=0.0),
        "ckpt_dir": None, "ckpt_every": 4, "keep": 3,
        "kill_at": None, "nan_at": [],
        "device": "cuda", "trace_dir": None,
        "out": os.path.join(workdir, "final.npz"),
        "meta_out": os.path.join(workdir, "meta.json"),
    }
    spec.update(overrides)
    return spec


def run_child(spec: dict, spec_path: str,
              timeout: float = 600) -> subprocess.CompletedProcess:
    """Write ``spec`` to ``spec_path`` and run the chaos child on it in a
    subprocess (a ``hard_kill`` SIGKILLs the child, not the caller). A
    killed child has ``returncode == -SIGKILL``. The child dies with the
    caller's process (``_die_with_parent``)."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env[_PARENT_ENV] = str(os.getpid())
    env["PYTHONPATH"] = (_src_root() + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.training.faults", spec_path],
        capture_output=True, text=True, env=env, timeout=timeout)


_PARENT_ENV = "REPRO_CHAOS_PARENT_PID"


def _die_with_parent() -> None:
    """On Linux, have the kernel SIGKILL this child when the process that
    ran ``run_child`` ends, so no child outlives a killed caller; exit at
    once if that process is already gone."""
    parent = os.environ.get(_PARENT_ENV)
    if parent is None or not sys.platform.startswith("linux"):
        return
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    if os.getppid() != int(parent):
        os._exit(1)


def chaos_child_main(argv: list[str]) -> None:
    """Entry point of the chaos child: build the spec's model, train
    (resuming from the newest intact checkpoint in ``ckpt_dir``), then
    write the final TrainState to ``out`` and the run's metadata to
    ``meta_out``. Deterministic algorithms are switched on first, before
    CUDA starts; an op without a deterministic variant warns instead of
    raising, and the warnings are kept in the metadata."""
    _die_with_parent()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import warnings

    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)

    with open(argv[0]) as f:
        spec = json.load(f)

    from repro_torch.checkpointing.checkpoint import (Checkpointer,
                                                      flatten_tree,
                                                      host_arrays)
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.prune_grow import BlastSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import adamw
    from repro_torch.training import train_loop

    cfg = ModelConfig(**spec["model"], blast=BlastSpec(**spec["blast"]))
    src = SyntheticLM(cfg.vocab_size, spec["seq_len"], spec["batch"],
                      seed=spec["data_seed"])
    opt = adamw.AdamWConfig(**spec["opt"])
    plan = TrainFaultPlan()
    if spec.get("kill_at") is not None:
        plan.hard_kill(spec["kill_at"])
    for s in spec.get("nan_at", []):
        plan.nan_grads(s)
    resumed_from = None
    restore_s = 0.0
    if spec.get("ckpt_dir"):
        t0 = time.monotonic()
        resumed_from = Checkpointer(spec["ckpt_dir"],
                                    keep=spec["keep"]).latest_intact_step()
        restore_s = time.monotonic() - t0
    loop = train_loop.TrainLoopConfig(
        total_steps=spec["steps"], ckpt_dir=spec.get("ckpt_dir"),
        ckpt_every=spec["ckpt_every"], keep=spec["keep"],
        log_every=10 ** 9)
    tracer = (Tracer(postmortem_dir=spec["trace_dir"])
              if spec.get("trace_dir") else None)
    t0 = time.monotonic()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, hist = train_loop.train(cfg, opt, src, loop, faults=plan,
                                       log_fn=lambda m: None,
                                       device=spec["device"],
                                       tracer=tracer)
    wall = time.monotonic() - t0
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    host, _ = host_arrays(flatten_tree(
        {"step": state.step, "params": state.params,
         "opt_state": state.opt_state, "masks": state.masks,
         "rng": state.generator}))
    np.savez(spec["out"], **host)
    counters = {k: hist[-1].get(k) for k in
                ("anomaly_steps", "skipped_steps", "rewinds",
                 "ckpt_fallbacks")} if hist else {}
    trace = None
    if tracer is not None:
        recs = list(tracer.records)
        names: dict[str, int] = {}
        for r in recs:
            names[r.name] = names.get(r.name, 0) + 1
        trace = {"records": names,
                 "train_step_s": [r.dur for r in recs
                                  if r.name == "train.step"],
                 "postmortems": [{"reason": p["reason"], "meta": p["meta"],
                                  "records": len(p["spans"]),
                                  "names": [s["name"] for s in p["spans"]]}
                                 for p in tracer.postmortems]}
    with open(spec["meta_out"], "w") as f:
        json.dump({"resumed_from": resumed_from, "wall_s": wall,
                   "verify_latency_s": restore_s, "fired": plan.fired,
                   "counters": counters, "nondeterministic_ops": nondet,
                   "trace": trace}, f)


if __name__ == "__main__":
    chaos_child_main(sys.argv[1:])
