"""The port's host KV store and schedulers against the reference's, under
seeded random operation sequences, bitwise: the store's records (logical
pages, bytes, crc32s over K then V), sizes, peaks, capacity errors and
checksum catches, with f32 pages and with bf16 pages (the pool's dtype,
kept as raw 16-bit words); FIFO and SLA admission order, removals,
re-instated relaunches and page-gate counts on an injected clock. No
model."""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import offload as joffload  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import offload as toffload  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

SHAPE = (2, 3, 4, 2, 8)        # layers, pages, page_size, KV, hd


def _pages(rng, n, dtype):
    """n pages of random words for each side: (reference k, v as numpy,
    port k, v as torch), the same bits."""
    shape = (SHAPE[0], n) + SHAPE[2:]
    out = []
    for _ in range(2):
        if dtype == "f32":
            a = rng.standard_normal(shape).astype(np.float32)
            out.append((a, torch.from_numpy(a.copy())))
        else:
            w = rng.integers(-2**15, 2**15, size=shape, dtype=np.int16)
            out.append((w.view(ml_dtypes.bfloat16),
                        torch.from_numpy(w.copy()).view(torch.bfloat16)))
    (jk, tk), (jv, tv) = out
    return jk, jv, tk, tv


def _raw(a):
    return (a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
            .numpy().tobytes() if isinstance(a, torch.Tensor)
            else np.ascontiguousarray(a).tobytes())


def _same_store(j, t):
    assert len(t) == len(j) and t.nbytes == j.nbytes
    assert t.bytes_peak == j.bytes_peak
    assert sorted(t._recs) == sorted(j._recs)
    for u, jr in j._recs.items():
        tr = t._recs[u]
        assert tr.logical == jr.logical and tr.checksums == jr.checksums
        assert _raw(tr.k) == _raw(jr.k) and _raw(tr.v) == _raw(jr.v)


def _call(fn, *a):
    """(result, exception type name, exception fields)."""
    try:
        return fn(*a), None, None
    except (AssertionError, ValueError, tfaults.ServingFault,
            jfaults.ServingFault) as e:
        fields = {k: getattr(e, k) for k in ("needed", "capacity", "used",
                                             "uid", "logical")
                  if hasattr(e, k)}
        return None, type(e).__name__, fields


# the reference asserts on a double save where the port raises ValueError
_SAME_ERROR = {("AssertionError", "ValueError")}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_matches_reference_under_random_ops(dtype, seed):
    rng = np.random.default_rng(seed)
    per_page = 2 * SHAPE[0] * np.prod(SHAPE[2:]) * (4 if dtype == "f32"
                                                    else 2)
    cap = int(per_page * 9)
    j, t = joffload.HostKVStore(cap), toffload.HostKVStore(cap)
    jplan = jfaults.FaultPlan().corrupt_offload(3, bit=5)
    tplan = tfaults.FaultPlan().corrupt_offload(3, bit=5)
    jplan.corrupt_offload(7, bit=1)
    tplan.corrupt_offload(7, bit=1)
    j.fault_hook, t.fault_hook = jplan.on_offload_save, tplan.on_offload_save
    kinds = []
    for _ in range(160):
        op = rng.choice(["save", "save", "pop", "extend", "drop", "reset"])
        uid = int(rng.integers(0, 6))
        if op in ("save", "extend"):
            n = int(rng.integers(1, 4))
            logical = sorted(rng.choice(12, size=n, replace=False).tolist())
            jk, jv, tk, tv = _pages(rng, n, dtype)
            if op == "extend" and uid not in j:
                continue
            jr = _call(getattr(j, op), uid, logical, jk, jv)
            tr = _call(getattr(t, op), uid, logical, tk, tv)
        elif op == "pop":
            jr, tr = _call(j.pop, uid), _call(t.pop, uid)
            if jr[0] is not None:
                assert tr[0].logical == jr[0].logical
                assert _raw(tr[0].k) == _raw(jr[0].k)
                assert _raw(tr[0].v) == _raw(jr[0].v)
            else:
                assert tr[0] is None
        elif op == "drop":
            jr, tr = _call(j.drop, uid), _call(t.drop, uid)
        else:
            jr, tr = _call(j.reset_peaks), _call(t.reset_peaks)
        assert (tr[1] == jr[1] or (jr[1], tr[1]) in _SAME_ERROR), op
        assert tr[2] == jr[2]
        kinds.append(tr[1])
        _same_store(j, t)
    assert tplan.fired == jplan.fired
    # the sequence reached every edge
    assert {"OffloadCapacityError", "OffloadCorruptionError",
            "ValueError", None} <= set(kinds)


def test_capacity_gate_changes_nothing():
    rng = np.random.default_rng(2)
    _, _, k, v = _pages(rng, 2, "f32")
    store = toffload.HostKVStore(capacity_bytes=2 * k.numel() * 4 + 10)
    store.save(1, [0, 1], k, v)
    with pytest.raises(tfaults.OffloadCapacityError) as ei:
        store.save(2, [0, 1], k, v)
    assert ei.value.used == store.nbytes and 2 not in store
    with pytest.raises(tfaults.OffloadCapacityError):
        store.extend(1, [2, 3], k, v)
    assert store._recs[1].logical == [0, 1]
    store.pop(1)
    store.save(2, [0, 1], k, v)
    with pytest.raises(ValueError, match="logical pages"):
        store.save(3, [0], k, v)


def test_bit_flip_caught_and_record_gone():
    rng = np.random.default_rng(3)
    _, _, k, v = _pages(rng, 2, "bf16")
    store = toffload.HostKVStore()
    plan = tfaults.FaultPlan().corrupt_offload(nth_save=0, bit=3)
    store.fault_hook = plan.on_offload_save
    store.save(9, [4, 6], k, v)
    assert _raw(store._recs[9].k) != _raw(k)     # the copy was flipped
    with pytest.raises(tfaults.OffloadCorruptionError) as ei:
        store.pop(9)
    assert ei.value.uid == 9 and ei.value.logical == [4]
    assert 9 not in store and plan.fired == ["bitflip:save0"]
    store.save(10, [0, 1], k, v)
    assert _raw(store.pop(10).k) == _raw(k)


# ---------------------------------------------------------------- schedulers
class Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _make(kind, clock):
    if kind == "fifo":
        return (jsched.FIFOScheduler(4, 64, clock=clock),
                tsched.FIFOScheduler(4, 64, clock=clock))
    aging = None if kind == "sla" else 2.0
    return (jsched.SLAScheduler(4, 64, aging_s=aging, clock=clock),
            tsched.SLAScheduler(4, 64, aging_s=aging, clock=clock))


def _req(mod, uid, rng, prio, deadline):
    return mod.Request(uid, rng.integers(1, 50, size=int(rng.integers(1, 9))),
                       int(rng.integers(1, 6)), priority=prio,
                       deadline_s=deadline)


def _queue(s):
    return [(r.uid, r.queued_at, r.deadline_at, r._seq) for r in s._queue]


@pytest.mark.parametrize("kind", ["fifo", "sla", "sla_aging"])
def test_scheduler_matches_reference_under_random_ops(kind):
    rng = np.random.default_rng({"fifo": 0, "sla": 1, "sla_aging": 2}[kind])
    clock = Clock()
    j, t = _make(kind, clock)
    uid, held = 0, []            # admitted requests, per side
    for _ in range(300):
        op = rng.choice(["submit", "submit", "admit", "remove", "push",
                         "reinstate", "head", "tick"])
        if op == "submit":
            prio = int(rng.integers(0, 3))
            dl = (float(rng.choice([0.5, 1.0, 3.0]))
                  if rng.random() < 0.5 else None)
            state = rng.bit_generator.state
            jr = _req(jsched, uid, rng, prio, dl)
            rng.bit_generator.state = state
            tr = _req(tsched, uid, rng, prio, dl)
            j.submit(jr)
            t.submit(tr)
            uid += 1
        elif op == "admit":
            n_free = int(rng.integers(0, 4))
            free = int(rng.integers(0, 20))

            def cost(g):
                return sum(r.prompt_len for r in g)
            a = j.admit(n_free, free, cost)
            b = t.admit(n_free, free, cost)
            assert [r.uid for r in b] == [r.uid for r in a]
            held.append((a, b))
        elif op == "remove":
            u = int(rng.integers(0, max(uid, 1)))
            a, b = j.remove(u), t.remove(u)
            assert (b is None) == (a is None)
        elif op == "push" and held:
            a, b = held.pop(int(rng.integers(0, len(held))))
            j.push_front(a)
            t.push_front(b)
        elif op == "reinstate" and held:
            a, b = held.pop(int(rng.integers(0, len(held))))
            fresh = [(jsched.Request(r.uid, r.prompt, r.max_new_tokens,
                                     priority=r.priority,
                                     deadline_s=r.deadline_s),
                      tsched.Request(r.uid, r.prompt, r.max_new_tokens,
                                     priority=r.priority,
                                     deadline_s=r.deadline_s))
                     for r in a]
            j.reinstate([x for x, _ in fresh])
            t.reinstate([y for _, y in fresh])
        elif op == "head":
            a, b = j.head(), t.head()
            assert (b.uid if b else None) == (a.uid if a else None)
        elif op == "tick":
            clock.t += float(rng.choice([0.25, 1.0, 2.5]))
        assert _queue(t) == _queue(j), op
        assert (t.rejections, t.rejected_steps) == (j.rejections,
                                                    j.rejected_steps)
        assert len(t) == len(j)


def test_sla_classes_deadlines_and_arrival():
    clock = Clock()
    s = tsched.SLAScheduler(8, 64, aging_s=None, clock=clock)
    p = np.ones(3, np.int32)
    s.submit(tsched.Request(0, p, 2, priority=tsched.BATCH))
    s.submit(tsched.Request(1, p, 2, priority=tsched.INTERACTIVE))
    s.submit(tsched.Request(2, p, 2, priority=tsched.INTERACTIVE,
                            deadline_s=5.0))
    s.submit(tsched.Request(3, p, 2, priority=tsched.INTERACTIVE,
                            deadline_s=1.0))
    s.submit(tsched.Request(4, p, 2, priority=tsched.BATCH))
    assert [r.uid for r in s.admit(8)] == [3, 2, 1, 0, 4]


def test_aging_lifts_a_waiting_batch_request():
    """With aging_s = 2, a batch request that waited 4 s outranks fresh
    interactive arrivals (class 1 - 2 < 0); without aging it starves."""
    for aging, want in ((2.0, 0), (None, 1)):
        clock = Clock()
        s = tsched.SLAScheduler(8, 64, aging_s=aging, clock=clock)
        s.submit(tsched.Request(0, np.ones(3, np.int32), 2,
                                priority=tsched.BATCH))
        clock.t += 4.0
        s.submit(tsched.Request(1, np.ones(3, np.int32), 2,
                                priority=tsched.INTERACTIVE))
        assert s.head().uid == want
        if aging:
            assert s.effective_priority(s._queue[0]) == -1


def test_stamps_and_validation():
    clock = Clock()
    s = tsched.FIFOScheduler(2, 16, clock=clock)
    r = tsched.Request(0, np.arange(1, 5), 8, deadline_s=2.5)
    clock.t = 123.0
    s.submit(r)
    assert (r.queued_at, r.deadline_at, r._seq) == (123.0, 125.5, 0)
    re = tsched.Request(1, np.arange(1, 5), 3, deadline_s=1.0)
    s.reinstate([re])
    assert s.head() is re and re._seq < 0 and re.deadline_at == 124.0
    with pytest.raises(ValueError, match="empty prompt"):
        tsched.Request(2, np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tsched.Request(2, np.ones(3, np.int32), 0)
    with pytest.raises(ValueError, match="aging_s"):
        tsched.SLAScheduler(2, 16, aging_s=0.0)
    s.extend([tsched.Request(5, np.ones(3, np.int32), 2)])
    assert s.remove(5).uid == 5 and s.remove(5) is None
