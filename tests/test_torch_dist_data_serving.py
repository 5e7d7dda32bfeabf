"""The serving data axis on the CPU: gloo ranks at (data 2, model 1) and
(data 2, model 2) against the reference's single device.

One scenario of 4 ranks, started once (``_torch_dist_rank.py``,
``dp_scenario``): ranks 0-1 as (data 2, model 1), then all four as (data
2, model 2), on two packed models (``test_torch_dist_serving``'s
``tiny`` at s = 0.8 on both meshes and Llama-3.2-1B's smoke config at
s = 0.7 on the second, f32).
Every rank is handed the whole traffic.

  * ``serve_loop.generate``: each data group runs its 2 of 4 rows and
    every rank returns all 4, equal to the reference's one-device streams
    but for near-ties (< 1e-5); B = 3, which 2 does not divide, is
    computed whole by every group; sampled draws equal the port's single
    device's from the same generator.
  * ``make_prefill_step``: every rank returns the whole (4, V) last
    logits, within 1e-5 of the reference's.
  * The paged ``Engine``, one replica a data group: 4 lanes, 2 a group;
    request i goes to group i mod 2. Each group's streams, block tables
    and page accounting after every step equal the reference's
    ``Engine(max_batch=2)`` fed that group's requests (bitwise; streams
    but for near-ties), phased, mixed (``tiny`` only) and with the prefix
    cache (``tiny`` only); every rank returns every request's result;
    the groups' digests are reported. An engine of 3 lanes is refused.
  * Infeasible submits raise on every rank and take no group's turn;
    ``admission_queue_limit`` is refused under a data axis.
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import _torch_dist_rank as ranks  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import serve_loop as jloop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from test_torch_dist_serving import (ENGINE, NEW, _models,  # noqa: E402
                                     _numpy_tree, _packed, _ref_engine,
                                     _reference_tree)
from test_torch_engine import (_assert_same_or_near_tie,  # noqa: E402
                               _ref_margin)
from test_torch_transformer import port_cfg  # noqa: E402

RUNS = {"tiny": ("phased", "mixed", "prefix"), "smoke": ("phased",)}
NAMES = tuple(RUNS)
MESHES = ("d2m1", "d2m2")
# the meshes each model runs on (the smoke model's ranks at (data 2,
# model 2) only, to keep the file's time)
ON = {"tiny": MESHES, "smoke": ("d2m2",)}
CASES = [(n, mesh) for n in NAMES for mesh in ON[n]]
LANES = 2 * ENGINE["max_batch"]     # the mesh's lanes: ENGINE's a group


def _traffic(vocab, seed=5):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 10).astype(np.int32)
    return dict(
        equal=rng.integers(1, vocab, (4, 8)).astype(np.int32),
        ragged=[rng.integers(1, vocab, int(n)).astype(np.int32)
                for n in (5, 9, 13, 3, 7)],
        prefix_prompts=[np.concatenate(
            [prefix, rng.integers(1, vocab, int(n)).astype(np.int32)])
            for n in (3, 5, 2, 6, 4, 1)])


def _sampled(cfg, tree, equal):
    from repro_torch.serving import serve_loop
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    return serve_loop.generate(cfg, interop.to_torch(tree, device="cpu"),
                               equal, max_new_tokens=NEW, temperature=0.8,
                               generator=gen, device="cpu")[0]


def _answers(jcfg, jtree, m):
    """The reference's one-device answers: ``generate`` on the 4 and 3
    rows, the forward's last logits, and per engine mode each data
    group's ``Engine(max_batch=2)`` on its requests."""
    out = {"loop": np.asarray(jloop.generate(jcfg, jtree, m["equal"],
                                             max_new_tokens=NEW)[0]),
           "loop3": np.asarray(jloop.generate(jcfg, jtree, m["equal"][:3],
                                              max_new_tokens=NEW)[0]),
           "prefill": np.asarray(jreg.forward(
               jcfg, jtree, jnp.asarray(m["equal"]))[0][:, -1]),
           "sampled": _sampled(m["cfg"], m["params"], m["equal"])}
    for mode in m["modes"]:
        prompts = m["prefix_prompts" if mode == "prefix" else "ragged"]
        out[mode] = [_ref_engine(jcfg, jtree, prompts[g::2],
                                 ranks.MODES[mode]) for g in range(2)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    models, ref = {}, {}
    engine = {k: v for k, v in ENGINE.items() if k != "max_batch"}
    for name, (jcfg, s) in _models().items():
        if name not in RUNS:
            continue
        tree = _numpy_tree(_packed(port_cfg(jcfg), s))
        models[name] = dict(cfg=port_cfg(jcfg), params=tree, engine=engine,
                            new=NEW, modes=RUNS[name], meshes=ON[name],
                            invalid=name == "tiny",
                            **_traffic(jcfg.vocab_size))
        ref[name] = (jcfg, _reference_tree(tree))
    d = str(tmp_path_factory.mktemp("dp"))
    procs = ranks.start(d, 4, train=dict(models=models, max_batch=LANES,
                                         mesh=(2, 2)), scenario="dp")
    with concurrent.futures.ThreadPoolExecutor(len(ref)) as pool:
        futs = {n: pool.submit(_answers, *ref[n], models[n]) for n in ref}
        answers = {n: f.result() for n, f in futs.items()}
    got = ranks.collect(d, procs)
    return {"ref": ref, "answers": answers, "models": models,
            "ranks": {k: [g[k] for g in got if k in g] for k in MESHES}}


def _margin_of(runs, name):
    jcfg, jtree = runs["ref"][name]
    return lambda seq: _ref_margin(jcfg, jtree, seq)


@pytest.mark.parametrize("name,mesh", CASES)
def test_generate_returns_every_row(runs, name, mesh):
    """Each rank returns all 4 rows (each data group ran 2), the
    reference's streams but for near-ties; B = 3 computed whole by both
    groups; every rank equal."""
    want = runs["answers"][name]
    got = runs["ranks"][mesh]
    plen = runs["models"][name]["equal"].shape[1]
    for r in got:
        g = r[name]
        assert g["loop"].shape == want["loop"].shape
        assert g["loop3"].shape == want["loop3"].shape
        for key in ("loop", "loop3"):
            for a, w in zip(g[key], want[key]):
                _assert_same_or_near_tie(a, w, plen, _margin_of(runs, name))
            np.testing.assert_array_equal(g[key], got[0][name][key])
    assert {r[name]["data_rank"] for r in got} == {0, 1}


@pytest.mark.parametrize("name,mesh", CASES)
def test_sampled_equals_one_device(runs, name, mesh):
    """A draw over the whole batch's gathered rows: the tokens one
    device's port draws from the same generator state."""
    for r in runs["ranks"][mesh]:
        np.testing.assert_array_equal(r[name]["sampled"],
                                      runs["answers"][name]["sampled"])


@pytest.mark.parametrize("name,mesh", CASES)
def test_prefill_step_returns_every_row(runs, name, mesh):
    want = runs["answers"][name]["prefill"]
    for r in runs["ranks"][mesh]:
        got = r[name]["prefill"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name,mode,mesh", [
    (n, mode, mesh) for n, mesh in CASES for mode in RUNS[n]])
def test_engine_groups_match_reference_replicas(runs, name, mode, mesh):
    """Each data group's block tables and page accounting after every
    step equal the reference ``Engine(max_batch=2)`` fed its requests
    (i mod 2), bitwise; every rank returns every request's stream, the
    reference group's but for near-ties, all ranks alike; a group's
    digest is the same on its model pair, and both groups' are
    reported."""
    m = runs["models"][name]
    prompts = m["prefix_prompts" if mode == "prefix" else "ragged"]
    want = runs["answers"][name][mode]
    got = runs["ranks"][mesh]
    first = None
    for r in got:
        e = r[name][mode]
        g = r[name]["data_rank"]
        assert e["lanes"] == ENGINE["max_batch"]
        assert e["snaps"] == want[g][1], (mesh, g)
        assert e["uids"] == list(range(len(prompts)))
        for u, p in enumerate(prompts):
            w = want[u % 2][0][u // 2]
            _assert_same_or_near_tie(np.asarray(e["streams"][u]), w, p.size,
                                     _margin_of(runs, name))
        first = first or e
        for a, b in zip(e["streams"], first["streams"]):
            np.testing.assert_array_equal(a, b)
        assert e["digests"] == first["digests"] and len(e["digests"]) == 2
    if mode == "prefix":
        assert sum(r[name][mode]["hits"] for r in got) > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_invalid_submits_refused_on_every_rank(runs, mesh):
    """An infeasible submit (empty prompt, zero budget, prompt filling
    ``max_len``) raises on every rank, whichever group it would have
    gone to, and takes no group's turn: the valid requests route and
    stream as without it. ``admission_queue_limit`` is refused under a
    data axis."""
    for r in runs["ranks"][mesh]:
        e = r["tiny"]["invalid"]
        assert e["raised"] == 3
        assert e["results"] == len(runs["models"]["tiny"]["ragged"])
        for a, b in zip(e["streams"], r["tiny"]["phased"]["streams"]):
            np.testing.assert_array_equal(a, b)
        assert e["shed_refused"]


@pytest.mark.parametrize("mesh", MESHES)
def test_uneven_lanes_refused(runs, mesh):
    for r in runs["ranks"][mesh]:
        assert all(r[n]["refused3"] for n in NAMES if mesh in ON[n])


# ---------------------------------------------------------- in-process
@pytest.mark.parametrize("shape,rank,batch,want", [
    ((2, 2), 0, 8, (0, 4)), ((2, 2), 3, 8, (4, 4)), ((2, 1), 1, 6, (3, 3)),
    ((2, 2), 2, 3, (0, 3)), ((1, 2), 1, 5, (0, 5)), ((4, 1), 2, 8, (4, 2)),
])
def test_batch_rows(shape, rank, batch, want):
    """A data group's rows: ``[r·B/dp, (r+1)·B/dp)``, the whole batch
    where dp does not divide it or is 1; the model axis does not
    enter."""
    d = DistContext(Mesh(("data", "model"), shape, rank))
    assert d.batch_rows(batch) == want


def test_model_only_view():
    """``model_only``: the model axis alone, this rank's coordinate on it
    (the batch axes gone), the same object without a data axis."""
    d = DistContext(Mesh(("data", "model"), (2, 2), 3), sp=False)
    v = d.model_only()
    assert v.mesh.axis_names == ("model",) and v.mesh.shape == (2,)
    assert v.tp == 2 and v.model_rank == 1 and v.data_size == 1
    assert v.sp is False
    one = DistContext(Mesh(("data", "model"), (1, 2), 1))
    assert one.model_only() is one
