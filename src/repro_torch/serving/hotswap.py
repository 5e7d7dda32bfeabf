"""Zero-downtime weight hot-swap with canary gating and automatic
rollback (port of ``repro/serving/hotswap.py``).

State machine (one swap at a time, driven between engine steps, the
engine's consistent host-sync point):

    IDLE -> STAGED  the artifact is validated (bytes and structure) and
                    its params placed on the engine's device beside the
                    serving set; serving never pauses;
         -> CANARY  the sealed golden generations are replayed on the
                    staged weights (``artifact.canary_run``); a failed
                    gate raises ``ArtifactCanaryError`` and the swap
                    never flips: no token of the bad weights is served;
         -> FLIPPED the generation counter bumps: new admissions decode
                    under the new params, every in-flight lane keeps its
                    admission-time generation (the engine splits its
                    slab and mixed calls per generation, so old streams
                    stay bitwise those of a run without the swap), and
                    the prefix cache is flushed (its pages hold old KV);
         -> COMMITTED after ``monitor_steps`` engine steps with at most
                    ``quarantine_limit`` new-generation quarantines; the
                    engine frees the old params when their last lane
                    retires;
         -> ROLLED_BACK when new-generation quarantines pass the limit
                    inside the window: another generation bump back to
                    the previous params object. Lanes admitted under the
                    bad generation keep their weights (re-pinning them
                    would mix weights within one stream); each is
                    quarantined on its own.

Observability: ``swap.stage``, ``swap.canary``, ``swap.flip`` and
``swap.rollback`` spans and the ``swap.commit`` event on the engine's
tracer, and the ``swap.validate_failure``, ``swap.canary_failure`` and
``swap.rollback`` postmortems of its flight recorder; the
``weight_swaps``, ``swap_canary_failures``, ``swap_rollbacks``,
``swap_canary_tokens`` and ``swap_quarantines`` counters and the
``weight_generation`` and ``weight_generations_held`` gauges in its
metrics registry.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.serving import artifact

IDLE = "IDLE"
STAGED = "STAGED"
CANARY = "CANARY"
FLIPPED = "FLIPPED"
COMMITTED = "COMMITTED"
ROLLED_BACK = "ROLLED_BACK"


@dataclasses.dataclass
class SwapReport:
    """Returned by ``swap_weights`` at flip time and updated by the
    monitor when the window closes (COMMITTED) or a quarantine spike
    rolls the swap back: callers keep the reference."""
    state: str
    from_gen: int
    to_gen: int
    fingerprint: str
    canary: dict
    stage_s: float
    canary_s: float
    flip_s: float
    monitor_steps: int
    quarantines: int = 0
    rollback_reason: str | None = None
    rollback_gen: int | None = None


class _SwapMonitor:
    """The post-flip watchdog the engine ticks: ``note_quarantine`` from
    ``_fail_lane`` (only new-generation lanes count: an old lane dying of
    an unrelated fault must not void a good swap) and ``on_step_end``
    from ``step()``. Commits at the window's end, rolls back on a
    quarantine spike."""

    def __init__(self, report: SwapReport, gen: int, prev_params,
                 monitor_steps: int, quarantine_limit: int):
        self.report = report
        self.gen = gen
        self.prev_params = prev_params
        self.remaining = monitor_steps
        self.limit = quarantine_limit

    def note_quarantine(self, gen: int, engine) -> None:
        if gen != self.gen:
            return
        self.report.quarantines += 1
        engine.stats["swap_quarantines"] += 1
        if self.report.quarantines > self.limit:
            _rollback(engine, self, "quarantine_spike")

    def on_step_end(self, engine) -> None:
        self.remaining -= 1
        if self.remaining > 0:
            return
        engine._swap_monitor = None
        self.report.state = COMMITTED
        if engine.tracer.enabled:
            engine.tracer.event("swap.commit", gen=self.gen,
                                quarantines=self.report.quarantines)


def _flip_generation(engine, params) -> int:
    """The generation bump shared by flip and rollback: new admissions
    route to ``params``, in-flight lanes keep theirs, and the prefix
    cache is flushed (its pages hold KV of another generation's weights;
    serving them to a new admission would mix weights in one stream)."""
    g = engine._gen + 1
    engine._gen = g
    engine._gen_params[g] = params
    engine.params = params
    if engine.pcache is not None:
        engine.pcache.flush()
    engine.stats["weight_generation"] = g
    engine.stats["weight_generations_held"] = len(engine._gen_params)
    return g


def _rollback(engine, mon: _SwapMonitor, reason: str) -> None:
    t0 = time.monotonic()
    engine._swap_monitor = None
    g = _flip_generation(engine, mon.prev_params)
    engine.stats["swap_rollbacks"] += 1
    r = mon.report
    r.state = ROLLED_BACK
    r.rollback_reason = reason
    r.rollback_gen = g
    engine.tracer.span_at("swap.rollback", t0, time.monotonic(),
                          bad_gen=mon.gen, to_gen=g, reason=reason,
                          quarantines=r.quarantines)
    engine.tracer.postmortem(
        "swap.rollback", bad_gen=mon.gen, restored_gen=g, cause=reason,
        quarantines=r.quarantines, fingerprint=r.fingerprint)


def swap_weights(engine, artifact_dir: str, *, monitor_steps: int = 8,
                 quarantine_limit: int = 0, max_token_mismatches: int = 0,
                 max_logit_drift: float = 0.0) -> SwapReport:
    """Stage a sealed artifact on the engine's device, replay its canaries
    and flip the engine onto it. Returns the live ``SwapReport`` in state
    FLIPPED; the installed monitor later moves it to COMMITTED or
    ROLLED_BACK. Raises the typed ``ArtifactError``, the serving weights
    untouched, when the artifact fails any layer. ``stage_s`` ends after
    a device sync, so it covers the upload."""
    if engine._swap_monitor is not None:
        raise RuntimeError(
            "previous swap is still in its monitoring window")
    tr = engine.tracer

    # STAGED: bytes and structure, then placement beside the live weights
    t0 = time.monotonic()
    try:
        params, manifest = artifact.load(artifact_dir, engine.cfg,
                                         device=engine.device)
    except artifact.ArtifactError as e:
        tr.postmortem("swap.validate_failure", artifact=artifact_dir,
                      error=type(e).__name__, detail=str(e))
        raise
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t1 = time.monotonic()
    tr.span_at("swap.stage", t0, t1, artifact=artifact_dir,
               fingerprint=manifest["fingerprint"])

    # CANARY: the behavioural layer, on the decode path
    gold = artifact.golden_logits(artifact_dir, manifest)
    try:
        canary = artifact.verify_canaries(
            engine.cfg, params, manifest, gold,
            max_token_mismatches=max_token_mismatches,
            max_logit_drift=max_logit_drift)
    except artifact.ArtifactCanaryError as e:
        engine.stats["swap_canary_failures"] += 1
        tr.span_at("swap.canary", t1, time.monotonic(),
                   artifact=artifact_dir, passed=False)
        tr.postmortem("swap.canary_failure", artifact=artifact_dir,
                      fingerprint=manifest["fingerprint"], detail=str(e))
        raise
    n_tok = sum(len(c["tokens"]) for c in manifest.get("canaries", []))
    engine.stats["swap_canary_tokens"] += n_tok
    t2 = time.monotonic()
    tr.span_at("swap.canary", t1, t2, artifact=artifact_dir, passed=True,
               tokens=n_tok)

    # FLIPPED: the generational cutover at the step boundary
    prev_gen, prev_params = engine._gen, engine.params
    g = _flip_generation(engine, params)
    engine.stats["weight_swaps"] += 1
    t3 = time.monotonic()
    tr.span_at("swap.flip", t2, t3, from_gen=prev_gen, to_gen=g,
               fingerprint=manifest["fingerprint"])
    report = SwapReport(
        state=FLIPPED, from_gen=prev_gen, to_gen=g,
        fingerprint=manifest["fingerprint"], canary=canary,
        stage_s=t1 - t0, canary_s=t2 - t1, flip_s=t3 - t2,
        monitor_steps=monitor_steps)
    engine._swap_monitor = _SwapMonitor(
        report, g, prev_params, monitor_steps, quarantine_limit)
    return report
