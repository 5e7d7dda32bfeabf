"""Training loop (port of ``repro/training/train_loop.py``): the train
step with BLaST prune-and-grow inside it, the anomaly guard, checkpoints
with resume and rewind, the preemption save and a wall-time straggler
watchdog.

  * auto-resume from the newest intact checkpoint in ``ckpt_dir`` (torn
    or corrupt ones are skipped through the crc32 manifest);
  * periodic async checkpoints every ``ckpt_every`` steps (keep-k,
    atomic, non-destructive); a failed background write surfaces on the
    next save or at the end;
  * K consecutive anomalies rewind: restore the newest intact checkpoint
    and replay (bitwise: batches are a function of (seed, step) and the
    generator is in the state). A spent rewind budget raises
    ``TrainingDivergedError``; without checkpoints the verdict takes the
    ``rewind_unavailable`` branch (log it, clear the streak, go on);
  * SIGTERM/SIGINT save one blocking checkpoint, then stop;
  * observability: ``tracer=`` records a ``train.step`` span per step,
    routes every structured event as ``train.<event>``, installs itself
    into the checkpointer and the guard, and dumps ``train_rewind`` and
    ``training_diverged`` postmortems; the loop's counters live on a
    ``MetricsRegistry(namespace="blast_train")`` (or the ``metrics=``
    one a caller injects, to scrape it).

Multi-device (``dist=``, a ``DistContext`` on a (data, model) mesh; the
dense family, GLU or two-matrix MLP, the VLM and whisper with their
frames or patches in the batch, and the MoE family): every rank runs this loop on its shard of the state
(``sharding.state_shardings``) with the sharded train step. Batches are
``source.batch(step)``, the same global batch as one device's, cut to
the data rank's rows (``sharding.slice_batch``). A checkpoint gathers
the logical state (a collective) and the mesh's rank 0 writes it,
blocking, before every rank goes on, so all ranks see the same files;
resume and rewind restore it onto whatever mesh the run has. Every host
decision reads values equal on all ranks: the loss and the anomaly flag
(reduced in the step), the slowest rank's step time and any rank's stop
signal (one small max all-reduce per step).

Two host reads per step: the step reads its loss and gradient norm
together to decide skip or update (``training/step.py``), and the loop
reads the step's metrics at every step, logged or not. Their sparsity is
a device scalar made after the update, so that read is stream-ordered
after AdamW and closes the step on the device. The step time ``dt``
(history's ``sec_per_step`` and the ``train.step`` span) runs from
before the step to that read, so every ``dt`` covers its whole step.
"""
from __future__ import annotations

import dataclasses
import signal
import sys
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpointing.checkpoint import Checkpointer
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim import adamw
from repro_torch.training import step as step_mod
from repro_torch.training.faults import (CheckpointCorruptionError,
                                        TrainingDivergedError)
from repro_torch.training.guard import AnomalyGuard, GuardConfig

# the loop's counters, registered with their help on its metrics registry
_COUNTER_HELP = (
    ("straggler_steps", "steps slower than factor x median"),
    ("ckpt_fallbacks", "corrupt/torn checkpoints skipped"),
    ("anomaly_steps", "steps with any anomaly verdict"),
    ("skipped_steps", "device-skipped (non-finite/grad) steps"),
    ("spike_steps", "host loss-spike verdicts"),
    ("rewinds", "automatic checkpoint rewinds"),
    ("steps_replayed", "steps re-run after rewinds"))
COUNTERS = tuple(name for name, _ in _COUNTER_HELP)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    straggler_factor: float = 3.0
    guard: GuardConfig | None = dataclasses.field(
        default_factory=GuardConfig)


def train(cfg, opt_cfg: adamw.AdamWConfig, source, loop: TrainLoopConfig,
          state=None, log_fn: Callable[[dict], None] | None = None,
          teacher_params=None, teacher_cfg=None, kd_beta: float = 0.0,
          faults=None, device="cuda", seed: int = 0, tracer=None,
          metrics=None, dist=None):
    """Returns (final_state, history).

    ``source.batch(step)`` gives numpy 'tokens' and 'labels'. Without a
    ``state`` the run starts from ``step.init_state(cfg, seed, device)``;
    with one, on its params' device; an intact checkpoint in
    ``loop.ckpt_dir`` replaces either, and the run resumes at its step.
    ``faults`` is an optional fault plan with the hooks of
    ``training/faults.py::TrainFaultPlan`` (``on_host_step``,
    ``step_scalars``, ``on_timed_step``, ``on_ckpt_saved``). History
    entries are step metrics (every ``log_every`` steps and the final
    step, which is always last) or structured events (``{"event":
    "straggler" | "rewind" | ...}``); each step-metrics entry carries the
    loop's counters.

    ``tracer`` (obs/trace.py) records the ``train.step`` spans and the
    ``train.*`` events and dumps the rewind and divergence postmortems;
    ``metrics`` injects the ``MetricsRegistry`` behind the counters (by
    default a private one), so a caller can scrape them.

    ``dist``: the sharded run (module docstring); ``state``, when given,
    is then this rank's shard, and whole ``teacher_params`` are cut to
    the rank's teacher shard once, here (``sharding.shard_teacher``)."""
    tr = NULL_TRACER if tracer is None else tracer
    reg = metrics if metrics is not None else MetricsRegistry(
        namespace="blast_train")
    gcfg = loop.guard if (loop.guard and loop.guard.enabled) else None
    if dist is not None and teacher_params is not None:
        from repro_torch.distributed import sharding
        teacher_params = sharding.shard_teacher(teacher_cfg or cfg,
                                                teacher_params, dist.mesh)
    step_fn = step_mod.make_train_step(
        cfg, opt_cfg, dist=dist, kd_beta=kd_beta, teacher_cfg=teacher_cfg,
        teacher_params_static=teacher_params, guard=gcfg is not None,
        grad_norm_limit=gcfg.grad_norm_limit if gcfg else None)
    if state is None:
        state = step_mod.init_state(cfg, seed, device, dist=dist)
    dev = adamw.tree_leaves(state.params)[0].device
    shardings = None
    if dist is not None:
        from repro_torch.distributed import sharding
        shardings = sharding.state_shardings(cfg, dist.mesh)

    ckpt = None
    if loop.ckpt_dir:
        writer = dist is None or dist.mesh.rank == 0
        if not writer:       # the writer recovers a killed run's leftovers
            _mesh_max(dist, dev, 0.0)
        ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep, writer=writer)
        if writer and dist is not None:
            _mesh_max(dist, dev, 0.0)
    if ckpt is not None:
        ckpt.tracer = tr
        if faults is not None:
            ckpt.fault_hook = faults.on_ckpt_saved
    start = 0
    if ckpt and ckpt.steps():
        # the newest intact checkpoint, verified as it is read (one pass
        # over its file); none intact: start afresh
        try:
            state = ckpt.restore_state(state, shardings=shardings)
        except CheckpointCorruptionError:
            pass
        else:
            start = state.step
            print(f"[resume] restored step {start} from {loop.ckpt_dir}")

    guard = AnomalyGuard(
        gcfg, step_size=(cfg.blast.step_size if cfg.blast.enabled
                         else 0)) if gcfg else None
    if guard is not None:
        guard.tracer = tr
    for name, help_ in _COUNTER_HELP:
        reg.counter(name, help_)
    counters = reg.view()

    stop = {"flag": False}

    def handler(signum, frame):  # noqa: ARG001
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, handler)
        except ValueError:   # not the main thread
            pass

    history: list[dict] = []
    durations: list[float] = []

    def emit(event: dict):
        history.append(event)
        if tr.enabled:
            # one schema for the history and the tracer
            tr.event("train." + event["event"],
                     **{k: v for k, v in event.items() if k != "event"})
        if log_fn:
            log_fn(event)
        else:
            print(f"[{event['event']}] {event}")

    try:
        i = start
        while i < loop.total_steps:
            if faults is not None:
                faults.on_host_step(i)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in source.batch(i).items()}
            if dist is not None:
                batch = sharding.slice_batch(batch, dist)
            if faults is not None:
                batch.update(faults.step_scalars(i))
            t0 = time.monotonic()
            if faults is not None:
                faults.on_timed_step(i)
            state, out = step_fn(state, batch)
            # read here, before dt, at every step: stream-ordered after
            # the update, this read closes the step on the device
            m = {k: float(v) for k, v in out.items()}
            dt = time.monotonic() - t0
            if dist is not None:
                # the slowest rank's time and any rank's stop signal
                dt, flag = _mesh_max(dist, dev, dt, float(stop["flag"]))
                stop["flag"] = flag > 0
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > loop.straggler_factor * med:
                counters["straggler_steps"] += 1
                emit({"event": "straggler", "step": i,
                      "sec_per_step": dt, "median_s": med})

            if tr.enabled:
                # from the step's own timestamps: no read of its own
                tr.span_at("train.step", t0, t0 + dt, step=i,
                           loss=out["loss"], anomaly=bool(out["anomaly"]))
            if guard is not None:
                verdict = guard.observe(i, out["loss"],
                                        bool(out["anomaly"]))
                counters.update(guard.counters)
                if verdict == "rewind":
                    target = None
                    if ckpt:
                        # join the write in flight first: the newest
                        # checkpoint counts whether or not its thread has
                        # finished (the reference asks without joining,
                        # so its rewind depends on thread timing)
                        ckpt.wait()
                        target = ckpt.latest_intact_step()
                    if (target is not None
                            and guard.counters["rewinds"]
                            < gcfg.max_rewinds):
                        # freeze the flight recorder first: the restore
                        # goes back in time, and the ring is the only
                        # record of the anomalous run-up
                        tr.postmortem("train_rewind", step=i,
                                      consecutive=guard.consecutive,
                                      rewinds=guard.counters["rewinds"])
                        state = ckpt.restore_state(state,
                                                   shardings=shardings)
                        counters["ckpt_fallbacks"] = ckpt.fallbacks
                        new_i = state.step
                        guard.note_rewind(i, new_i)
                        counters.update(guard.counters)
                        emit({"event": "rewind", "step": i,
                              "to_step": new_i,
                              "consecutive": gcfg.max_consecutive})
                        i = new_i
                        continue
                    if ckpt is not None:
                        tr.postmortem(
                            "training_diverged", step=i,
                            consecutive=guard.consecutive,
                            rewinds=guard.counters["rewinds"])
                        raise TrainingDivergedError(
                            i, guard.consecutive,
                            guard.counters["rewinds"])
                    guard.reset()
                    emit({"event": "rewind_unavailable", "step": i})

            if i % loop.log_every == 0 or i == loop.total_steps - 1:
                if ckpt:
                    counters["ckpt_fallbacks"] = ckpt.fallbacks
                m.update(step=i, sec_per_step=dt, **counters)
                history.append(m)
                if log_fn:
                    log_fn(m)
                else:
                    print(f"step {i:5d} loss {m['loss']:.4f} "
                          f"sparsity {m['sparsity']:.3f} {dt:.2f}s")
            if ckpt and ((i + 1) % loop.ckpt_every == 0):
                _save(ckpt, i + 1, state, dist, shardings, dev)
            if stop["flag"]:
                print(f"[preempt] signal at step {i}; checkpointing")
                if ckpt:
                    _save(ckpt, i + 1, state, dist, shardings, dev,
                          blocking=True)
                break
            i += 1
    finally:
        propagating = sys.exc_info()[1] is not None
        if ckpt:
            if propagating:
                try:          # do not mask the in-flight exception
                    ckpt.wait()
                except Exception:
                    pass
            else:
                ckpt.wait()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return state, history


def _mesh_max(dist, dev, *vals):
    """The maxima of host numbers over every rank of the mesh (one small
    all-reduce per mesh axis; a barrier too)."""
    t = torch.tensor(vals, dtype=torch.float64, device=dev)
    return dist.max_over_mesh(t).tolist()


def _save(ckpt, step, state, dist, shardings, dev, blocking=False):
    """One device: the checkpointer's own save. Sharded: the logical
    state is gathered leaf by leaf, each whole leaf copied to the
    writer's host memory and dropped on the device at once (the other
    ranks drop it), the writer saves the host copy blocking, and no rank
    goes on before the files are in place."""
    if dist is None:
        ckpt.save(step, state, blocking=blocking)
        return
    from repro_torch.distributed import sharding
    host = sharding.gather_state(
        state, shardings,
        (lambda t: t.cpu()) if ckpt.writer else (lambda t: None))
    if ckpt.writer:
        ckpt.save(step, host, blocking=True)
    del host
    _mesh_max(dist, dev, 0.0)
