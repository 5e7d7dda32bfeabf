"""Asyncio front door over the serving engine (port of
``repro/serving/frontend.py``).

The engine is a synchronous step loop. Here one thread steps it
continuously, and an asyncio facade submits requests into it and streams
tokens back as slabs and mixed steps complete::

    async with AsyncEngine(engine) as front:
        stream = await front.submit_async(prompt, max_new_tokens=64)
        async for toks in stream:      # list[int] per engine sync
            ...
        res = await stream.result()    # the engine's GenResult

Concurrency, without locks:

  * the event-loop side only appends to deques (inbox, cancels) and sets
    a ``threading.Event``, so ``submit_async`` never blocks the loop on
    engine work;
  * the engine thread owns the engine: it drains the inbox (through
    ``engine.submit``, whose rejections go back through the caller's
    future), steps while work is in flight, and pushes new tokens to each
    request's stream;
  * every hop back to the loop goes through
    ``loop.call_soon_threadsafe``.

Fault tolerance: a watchdog thread (``watchdog_s``, ``max_recoveries``)
heartbeats the stepper. When the stepper dies, or a step overruns the
deadline and aborts once condemned, the watchdog runs
``Supervisor.recover`` (live lanes' KV salvaged to the host, the rest
relaunched) and restarts stepping; open streams see a pause. A step that
overran but does not abort under condemnation is left running as a false
alarm: the watchdog cannot kill a CUDA call, and recovering beside a
stepper that still writes the cache in place would corrupt what it
salvages. Past the recovery budget, or when recovery fails, the open
streams fail with the error. A request that fails alone (quarantine,
cancel, deadline) fails only its own stream.

``await front.aclose()`` drains in-flight work, joins the threads and
finalizes the engine's stats; a stream that can no longer finish fails
with ``RequestCancelledError`` instead of hanging its consumer. The
reference's ``/metrics`` endpoint, hot-swap queue and flight-recorder
dumps are not ported.
"""
from __future__ import annotations

import asyncio
import threading
import time
from collections import deque

import numpy as np

from repro_torch.serving.faults import EngineHangError, RequestCancelledError
from repro_torch.serving.recovery import Supervisor

_DONE = object()


class TokenStream:
    """One request's async token stream and final result.

    Iterating yields ``list[int]`` batches, one per engine host sync;
    ``await stream.result()`` returns the ``GenResult`` or raises the
    request's structured error. Made by ``AsyncEngine.submit_async``; the
    engine thread mutates it only through the ``*_threadsafe`` methods."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._q: asyncio.Queue = asyncio.Queue()
        self._submitted = loop.create_future()   # -> uid, or raises
        self._result = loop.create_future()      # -> GenResult
        self._front: "AsyncEngine | None" = None
        self._cancelled = False

    @property
    def uid(self) -> int:
        """Engine-assigned request uid (valid once submitted)."""
        return self._submitted.result()

    # ---- engine-thread side
    def _call(self, fn) -> None:
        try:
            self._loop.call_soon_threadsafe(fn)
        except RuntimeError:
            pass   # the loop is closed: nobody is listening

    def _submit_ok_threadsafe(self, uid: int) -> None:
        self._call(lambda: self._submitted.set_result(uid))

    def _reject_threadsafe(self, exc: BaseException) -> None:
        # submit-time rejection: ``await submit_async`` raises, the stream
        # is never handed out, so the result just closes
        def fail():
            if not self._submitted.done():
                self._submitted.set_exception(exc)
            if not self._result.done():
                self._result.set_result(None)
            self._q.put_nowait(_DONE)
        self._call(fail)

    def _push_threadsafe(self, toks: list[int]) -> None:
        self._call(lambda: self._q.put_nowait(list(toks)))

    def _finish_threadsafe(self, res) -> None:
        def fin():
            if not self._result.done():
                self._result.set_result(res)
            self._q.put_nowait(_DONE)
        self._call(fin)

    def _fail_threadsafe(self, exc: BaseException) -> None:
        # a request's own failure, a crash past the recovery budget, or
        # the shutdown sweep; a no-op on a finished stream
        def fail():
            if not self._submitted.done():
                self._submitted.set_exception(exc)
            if not self._result.done():
                self._result.set_exception(exc)
            self._q.put_nowait(_DONE)
        self._call(fail)

    # ---- event-loop side
    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> list[int]:
        item = await self._q.get()
        if item is _DONE:
            raise StopAsyncIteration
        return item

    async def result(self):
        """The engine's ``GenResult``; raises the structured error when
        the request failed."""
        return await self._result

    async def cancel(self) -> None:
        """Cancel this request wherever it is (inbox, queue, lane,
        preempted); the stream ends with its ``RequestCancelledError``
        swallowed here. A no-op when called again or after the request
        finished."""
        if self._front is None or self._result.done():
            return
        self._cancelled = True
        if self._submitted.done():
            if self._submitted.exception() is None:
                self._front._cancels.append(self._submitted.result())
        else:
            # not yet submitted: the drain rejects flagged entries; if the
            # submission raced past the flag, cancel once the uid lands
            def _then(fut):
                if not fut.cancelled() and fut.exception() is None:
                    self._front._cancels.append(fut.result())
                    self._front._wake.set()
            self._submitted.add_done_callback(_then)
        self._front._wake.set()
        try:
            await self._result
        except Exception:
            pass     # the cancellation (or a racing failure) itself


class AsyncEngine:
    """Asyncio facade stepping an ``Engine`` on its own thread; nobody
    else may drive the engine meanwhile.

    ``idle_wait_s`` bounds the idle poll between an inbox entry and the
    thread noticing it (the wake event usually cuts it short).
    ``watchdog_s`` arms the hung-step deadline; ``max_recoveries`` bounds
    how often the supervisor may rebuild the engine before the open
    streams fail (0: the first crash fails them). ``recovery_log`` keeps
    one summary per recovery."""

    def __init__(self, engine, *, idle_wait_s: float = 0.002,
                 watchdog_s: float | None = None,
                 max_recoveries: int = 0):
        self.engine = engine
        self._idle_wait_s = idle_wait_s
        # the loop side appends, the engine thread pops: both atomic
        self._inbox: deque = deque()
        self._cancels: deque = deque()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._streams: dict[int, TokenStream] = {}
        self._sent: dict[int, int] = {}   # uid -> tokens already pushed
        self._watchdog_s = watchdog_s
        self._max_recoveries = max_recoveries
        self._recoveries = 0
        self.recovery_log: list[dict] = []
        self._beat = time.monotonic()
        self._busy = False
        self._crash: BaseException | None = None
        self._monitor: threading.Thread | None = None
        self._mon_stop = threading.Event()

    # ------------------------------------------------------ lifecycle
    def _recovery_enabled(self) -> bool:
        return (self._recoveries < self._max_recoveries
                and self._monitor is not None and not self._stop)

    def start(self) -> "AsyncEngine":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="serving-engine", daemon=True)
            self._thread.start()
        if (self._monitor is None
                and (self._watchdog_s is not None
                     or self._max_recoveries > 0)):
            self._mon_stop.clear()
            self._monitor = threading.Thread(
                target=self._watch, name="serving-watchdog", daemon=True)
            self._monitor.start()
        return self

    async def __aenter__(self) -> "AsyncEngine":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Drain in-flight work, stop the engine and watchdog threads,
        finalize the engine's stats, and fail every stream that can no
        longer finish. Safe to call twice; submitting afterwards
        raises."""
        self._stop = True
        self._wake.set()
        loop = asyncio.get_running_loop()
        # the monitor first: no recovery may restart a stepper under us
        if self._monitor is not None:
            self._mon_stop.set()
            await loop.run_in_executor(None, self._monitor.join)
            self._monitor = None
        self.engine._condemned.set()   # abort a wedged step
        if self._thread is not None:
            await loop.run_in_executor(None, self._thread.join)
            self._thread = None
        self.engine._condemned.clear()
        leftovers = list(self._streams.values())
        self._streams.clear()
        self._sent.clear()
        while self._inbox:
            leftovers.append(self._inbox.popleft()[-1])
        exc = RequestCancelledError(-1, "cancelled: engine shut down")
        for s in leftovers:
            s._fail_threadsafe(exc)

    # --------------------------------------------------------- submit
    async def submit_async(self, prompt, max_new_tokens: int = 32, *,
                           priority: int = 0,
                           deadline_s: float | None = None) -> TokenStream:
        """Queue one request; resolves once the engine accepted it. An
        infeasible request raises ``ValueError`` here and a shed one
        ``BackpressureError``. ``priority`` and ``deadline_s`` go to the
        scheduler."""
        if self._thread is None or self._stop:
            raise RuntimeError(
                "AsyncEngine is not running: use 'async with "
                "AsyncEngine(engine)' or call start()")
        stream = TokenStream(asyncio.get_running_loop())
        stream._front = self
        self._inbox.append((np.asarray(prompt, np.int32), max_new_tokens,
                            priority, deadline_s, stream))
        self._wake.set()
        await stream._submitted
        return stream

    # -------------------------------------------------- engine thread
    def _drain_inbox(self) -> None:
        eng = self.engine
        while self._inbox:
            prompt, mnt, prio, dl, stream = self._inbox.popleft()
            if stream._cancelled:
                stream._reject_threadsafe(RequestCancelledError(
                    -1, "cancelled before submission"))
                continue
            try:
                uid = eng.submit(prompt, mnt, priority=prio,
                                 deadline_s=dl)
            except Exception as e:
                stream._reject_threadsafe(e)
                continue
            self._streams[uid] = stream
            self._sent[uid] = 0
            stream._submit_ok_threadsafe(uid)

    def _drain_cancels(self) -> None:
        while self._cancels:
            self.engine.cancel(self._cancels.popleft())

    def _has_work(self) -> bool:
        eng = self.engine
        return bool(eng.active_lanes or len(eng.scheduler)
                    or eng._preempted or eng._pending_results)

    def _pump(self, finished) -> None:
        """Push the tokens that landed at this step's sync: each live
        lane's tokens past what was sent (a preempted lane pauses; a
        relaunched one counts the tokens emitted before the crash), then
        the finished requests' tails and results, or their errors."""
        eng = self.engine
        for i in eng.active_lanes:
            lane = eng.lanes[i]
            stream = self._streams.get(lane.req.uid)
            if stream is None:
                continue
            gen = lane.generated
            pre = eng._recovered_prefix.get(lane.req.uid)
            if pre is not None:
                gen = list(pre[1]) + gen
            sent = self._sent[lane.req.uid]
            if len(gen) > sent:
                stream._push_threadsafe(gen[sent:])
                self._sent[lane.req.uid] = len(gen)
        for res in finished:
            stream = self._streams.pop(res.uid, None)
            sent = self._sent.pop(res.uid, 0)
            if stream is None:
                continue
            if res.error is not None:
                stream._fail_threadsafe(res.error)
                continue
            if len(res.generated) > sent:
                stream._push_threadsafe(
                    [int(t) for t in res.generated[sent:]])
            stream._finish_threadsafe(res)

    def _run(self) -> None:
        eng = self.engine
        try:
            while True:
                self._beat = time.monotonic()
                self._drain_cancels()
                self._drain_inbox()
                if self._has_work():
                    self._busy = True
                    try:
                        finished = eng.step()
                    finally:
                        self._busy = False
                    self._pump(finished)
                elif self._stop and not self._inbox:
                    break
                else:
                    self._wake.wait(self._idle_wait_s)
                    self._wake.clear()
        except Exception as e:
            if self._recovery_enabled():
                # die quietly with the crash stashed: the streams stay
                # open and the watchdog recovers
                self._crash = e
                return
            for stream in list(self._streams.values()):
                stream._fail_threadsafe(e)
            self._streams.clear()
            raise
        finally:
            eng.finalize_stats()

    # ------------------------------------------------- watchdog thread
    def _watch(self) -> None:
        """Recover a dead stepper (its crash stashed by ``_run``), and
        condemn then recover a hung one (a step running past
        ``watchdog_s``). Each recovery spends one of ``max_recoveries``."""
        poll = min(0.01, (self._watchdog_s or 1.0) / 4)
        while not self._mon_stop.wait(poll):
            t = self._thread
            if t is None:
                continue
            if not t.is_alive():
                crash, self._crash = self._crash, None
                if crash is not None:
                    self.engine.stats["engine_crashes"] += 1
                    self._do_recover(crash)
                continue
            if (self._watchdog_s is not None and self._busy
                    and time.monotonic() - self._beat > self._watchdog_s):
                self.engine._condemned.set()
                t.join(self._watchdog_s + 1.0)
                if t.is_alive():
                    # the step did not abort under condemnation: it is
                    # slow, not wedged, and may still be writing the cache;
                    # stand down and give it a fresh deadline
                    self.engine._condemned.clear()
                    self._beat = time.monotonic()
                    continue
                # the condemned thread is down; a crash it stashed itself
                # (raced the condemnation) is the real cause
                crash, self._crash = self._crash, None
                if crash is not None and not isinstance(crash,
                                                        EngineHangError):
                    self.engine.stats["engine_crashes"] += 1
                    self._do_recover(crash)
                else:
                    self.engine.stats["watchdog_hangs"] += 1
                    self._do_recover(EngineHangError())

    def _do_recover(self, exc: BaseException) -> None:
        """One supervisor pass and a stepper restart (on the watchdog
        thread; the stepper is confirmed dead)."""
        if self._recoveries >= self._max_recoveries or self._stop:
            for s in list(self._streams.values()):
                s._fail_threadsafe(exc)
            self._streams.clear()
            return
        self._recoveries += 1
        try:
            summary = Supervisor(self.engine).recover(exc)
        except Exception as e2:
            for s in list(self._streams.values()):
                s._fail_threadsafe(e2)
            self._streams.clear()
            return
        self.recovery_log.append(summary)
        self._thread = threading.Thread(
            target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        self._wake.set()
