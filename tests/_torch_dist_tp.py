"""The reference side of ``test_torch_dist_mlp2.py`` and
``test_torch_dist_audio_vlm.py``: tensor parallelism (``dist=``) on the
two-matrix MLP and on the vlm and audio families, gloo ranks of
``_torch_dist_rank.py``'s ``tp_scenario`` held against the reference's
single-device functions.

``start`` builds, for two models (one per pair of ranks), the weights
(the port's seeded init, true fan-in, with the norms, biases and padded
heads drawn from a numpy seed: ``test_torch_whisper._drawn``, so that
``b_in``/``b_out`` and every head are live), the train state (one-shot
masks at 0.5, zero moments), the packed serving tree (s = 0.7, f32),
the traffic and the batches, writes them for the 4 ranks and starts
them; ``collect`` computes the reference's answers meanwhile (the
training forward, the gradients, ``make_train_step`` on the global
batch, ``serve_loop.generate``, the paged engine's streams and host
states, whisper's ``prefill_cross``) and gathers the ranks'. The
``check_*`` helpers hold the ranks to ROADMAP's parity bar: f32 outputs
within 1e-5 of their magnitude, losses and gradient norms to 1e-5
relative, params to 5e-5, masks and block tables bitwise, greedy
streams equal but for near-ties.
"""
import concurrent.futures
import dataclasses
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

import _torch_dist_rank as ranks
from repro.models import registry as jreg
from repro.models import whisper as jwh
from repro.optim import adamw as jadamw
from repro.serving import serve_loop as jloop
from repro.training import step as jts
from repro_torch import interop
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import export as texport
from test_torch_dist_serving import (ENGINE, NEW, _numpy_tree, _ref_engine,
                                     _ref_logits, _reference_tree, _traffic)
from test_torch_engine import _assert_same_or_near_tie, _margin, _ref_margin
from test_torch_rwkv6 import _close, one_shot
from test_torch_transformer import port_cfg
from test_torch_whisper import _drawn

LR, RTOL, PARAM_ATOL, GRAD_REL = 1e-4, 1e-5, 5e-5, 1e-5
B, S, S_ENC = 4, 12, 10      # the global batch: 2 rows a data rank
SPARSITY = 0.7
MODES = ("phased", "mixed")
# the models whose engines also run the prefix cache (a reference engine
# compile each)
PREFIX = ("odd", "vlm")


def opts():
    kw = dict(peak_lr=LR, total_steps=20, warmup_steps=0)
    return jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)


def weights(jcfg, seed):
    """(reference params, numpy params): the port's seeded init with
    drawn norms, biases and padded heads."""
    raw = interop.to_numpy(treg.init_params(port_cfg(jcfg), seed, "cpu"))
    npt = _drawn(raw, seed + 100, jcfg.num_heads)
    return jax.tree_util.tree_map(jnp.asarray, npt), npt


def _states(jcfg, jp, npt):
    """(the reference's TrainState, the same state as numpy): step 0,
    the one-shot masks at 0.5, zero moments."""
    masks = {k: np.asarray(v) for k, v in one_shot(jcfg, jp, 0.5).items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, npt)
    host = types.SimpleNamespace(step=np.asarray(0, np.int32), params=npt,
                                 opt_state={"m": zeros, "v": zeros},
                                 masks=masks)
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    return jts.TrainState(step=jnp.zeros((), jnp.int32), params=as_j(npt),
                          opt_state=as_j(host.opt_state), masks=as_j(masks),
                          rng=jax.random.PRNGKey(0)), host


def packed(cfg, npt, s=SPARSITY):
    """The launcher's one-shot magnitude prune at ``s`` of ``npt``,
    packed in f32 by the port, as numpy (packs as namespaces)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    params = interop.to_torch(npt, device="cpu")
    spec = dataclasses.replace(cfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in treg.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return _numpy_tree(texport.pack_params(cfg, params, masks,
                                           dtype=torch.float32))


def _extra(jcfg, rng, b, s_enc=S_ENC):
    """Whisper's frames or a VLM's patch embeddings (seeded normals x
    0.02) for ``b`` rows; nothing for a text model."""
    if jcfg.family == "audio":
        return {"frames": (rng.standard_normal((b, s_enc, jcfg.d_model))
                           * 0.02).astype(np.float32)}
    if jcfg.family == "vlm":
        return {"patch_embeds": (rng.standard_normal(
            (b, jcfg.num_patches, jcfg.d_model)) * 0.02).astype(np.float32)}
    return {}


def _batch(jcfg, seed, source=None):
    """A global batch of ``B`` x ``S`` tokens and labels (``source``'s
    batch 0 where given) and the family's extra input."""
    rng = np.random.default_rng(seed)
    if source is not None:
        b = {k: np.asarray(v) for k, v in source.batch(0).items()}
    else:
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return dict(b, **_extra(jcfg, rng, B))


def _model(jcfg, seed, source=None, modes=MODES):
    """One model's part of the spec and the reference's inputs."""
    cfg = port_cfg(jcfg)
    jp, npt = weights(jcfg, seed)
    js, host = _states(jcfg, jp, npt)
    tree = packed(cfg, npt)
    rng = np.random.default_rng(seed + 1)
    fwd = (rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32),
           _extra(jcfg, rng, 2))
    serve = dict(cfg=cfg, params=tree, engine=ENGINE, new=NEW, modes=modes,
                 **_traffic(jcfg.vocab_size))
    if jcfg.family == "audio":
        serve["frames"] = _extra(jcfg, rng, len(serve["equal"]))["frames"]
    m = dict(cfg=cfg, state=host, fwd=fwd, serve=serve,
             batch=_batch(jcfg, seed + 2, source))
    if jcfg.family == "audio":
        # the (data 2, model 2) step's frames: S_enc 9 does not split,
        # so the encoder's stream stays whole while the decoder's splits
        m["batch2"] = dict(m["batch"], **_extra(jcfg, rng, B, S_ENC - 1))
    return m, dict(jcfg=jcfg, jp=jp, js=js, jtree=_reference_tree(tree))


def start(tmp_path_factory, jcfgs: dict, loop: str | None = None,
          source=None):
    """Start the 4 ranks on ``jcfgs`` (name -> reference config, two of
    them: ranks 0-1 run the first, 2-3 the second); ``loop`` names the
    model whose ``source`` ``train_loop.train`` takes at (data 2, model
    2). Returns what ``collect`` needs."""
    _, topt = opts()
    names = tuple(jcfgs)
    models, ref = {}, {}
    for i, (name, jcfg) in enumerate(jcfgs.items()):
        models[name], ref[name] = _model(
            jcfg, 30 + 10 * i, source if name == loop else None,
            MODES + ("prefix",) if name in PREFIX else MODES)
    d = str(tmp_path_factory.mktemp("tp"))
    procs = ranks.start(d, 4, train=dict(pairs=names, models=models,
                                         opt=topt, source=source, loop=loop,
                                         mesh=(2, 2)), scenario="tp")
    return d, procs, models, ref


def _step(jcfg, jopt, js, batch):
    st, met = jax.jit(jts.make_train_step(jcfg, jopt))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(metrics={k: float(v) for k, v in met.items()},
                **jax.device_get({"params": st.params,
                                  "masks": dict(st.masks)}))


def _grads(jcfg, js, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_get(jax.jit(jax.grad(
        lambda p: jts.loss_fn(jcfg, p, js.masks, jb)[0]))(js.params))


def _serving(jcfg, jtree, sv):
    """The reference's serving of the packed tree: greedy
    ``serve_loop.generate`` streams (with whisper's frames, and its
    ``prefill_cross``), and for the transformers the next-token logits
    and the paged engine's streams and per-step host states."""
    if jcfg.family == "audio":
        fr = jnp.asarray(sv["frames"])
        ck, cv = jwh.prefill_cross(jcfg, jtree, fr, dtype=jnp.float32)
        return dict(loop=np.asarray(jloop.generate(
            jcfg, jtree, jnp.asarray(sv["equal"]), max_new_tokens=NEW,
            frames=fr)[0]), ck=np.asarray(ck), cv=np.asarray(cv))
    return dict(
        loop=np.asarray(jloop.generate(jcfg, jtree, sv["equal"],
                                       max_new_tokens=NEW)[0]),
        logits=[_ref_logits(jcfg, jtree, p) for p in sv["logit_prompts"]],
        **{mode: _ref_engine(jcfg, jtree, sv["prefix_prompts" if mode ==
                                             "prefix" else "ragged"],
                             ranks.MODES[mode])
           for mode in sv["modes"]})


def _sampled(cfg, sv):
    """The port's own single-device sampled draws (the ranks must draw
    the same tokens)."""
    from repro_torch.serving import serve_loop
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    return serve_loop.generate(cfg, interop.to_torch(sv["params"],
                                                     device="cpu"),
                               sv["equal"], max_new_tokens=NEW,
                               temperature=0.8, generator=gen,
                               device="cpu")[0]


def _answers(m, r):
    """One model's reference answers into ``r``."""
    jopt, _ = opts()
    jcfg = r["jcfg"]
    toks, extra = m["fwd"]
    r["logits"] = np.asarray(jreg.forward(
        jcfg, r["jp"], jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in extra.items()})[0])
    r["step"] = _step(jcfg, jopt, r["js"], m["batch"])
    r["step2"] = (_step(jcfg, jopt, r["js"], m["batch2"])
                  if "batch2" in m else r["step"])
    r["grads"] = _grads(jcfg, r["js"], m["batch"])
    r["serve"] = _serving(jcfg, r["jtree"], m["serve"])
    if jcfg.family != "audio":
        r["serve"]["sampled"] = _sampled(m["cfg"], m["serve"])


def collect(d, procs, models, ref):
    """The reference's answers for every model (computed while the ranks
    run, a thread a model: XLA compiles them side by side), then the
    ranks'. -> {"ref": name -> answers, "ranks": name -> its pair's
    results, "all": every rank's}."""
    with concurrent.futures.ThreadPoolExecutor(len(ref)) as pool:
        for f in [pool.submit(_answers, models[n], r) for n, r in ref.items()]:
            f.result()
    got = ranks.collect(d, procs)
    return {"ref": ref, "models": models, "all": got,
            "ranks": {n: [g for g in got if g["name"] == n] for n in ref}}


# ---------------------------------------------------------------- checks
def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def check_logits(runs, name, sp):
    """Every rank's whole logits against the reference's forward."""
    want = runs["ref"][name]["logits"]
    for r in runs["ranks"][name]:
        _close(r["logits"][sp], want)


def check_step(got, want):
    m, w = got["metrics"], want["metrics"]
    for k in ("loss", "grad_norm"):
        assert abs(m[k] - w[k]) <= RTOL * abs(w[k]), (k, m[k], w[k])
    for path, wp in leaves(want["params"]):
        np.testing.assert_allclose(get(got["params"], path), wp, rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    for path, wm in want["masks"].items():
        np.testing.assert_array_equal(got["masks"][path], wm, err_msg=path)


def grad_errs(got, want) -> dict:
    """path -> max abs error of a gradient leaf over its magnitude."""
    return {p: float(np.abs(get(got, p) - w).max()
                     / max(np.abs(w).max(), 1e-30))
            for p, w in leaves(want)}


def check_serve_loop(runs, name):
    """Greedy streams equal the reference's but for near-ties; the
    transformers' sampled draws equal the port's single device's and
    their gathered logits the reference's within 1e-5."""
    r, sv = runs["ref"][name], runs["models"][name]["serve"]
    jcfg, jtree = r["jcfg"], r["jtree"]
    plen = sv["equal"].shape[1]
    for rank in runs["ranks"][name]:
        got = rank["serve"]
        for lane, (g, w) in enumerate(zip(got["loop"], r["serve"]["loop"])):
            if jcfg.family == "audio":
                def margin(seq, lane=lane):
                    last, _ = jloop.prefill_with_decode(
                        jcfg, jtree, jnp.asarray(seq)[None], len(seq),
                        frames=jnp.asarray(sv["frames"][lane:lane + 1]))
                    return _margin(last[0])
            else:
                def margin(seq):
                    return _ref_margin(jcfg, jtree, seq)
            _assert_same_or_near_tie(np.asarray(g), w, plen, margin)
        if jcfg.family == "audio":
            continue
        np.testing.assert_array_equal(got["sampled"],
                                      r["serve"]["sampled"])
        for g, w in zip(got["logits"], r["serve"]["logits"]):
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max())


def check_engine(runs, name, mode):
    """Streams equal the reference engine's but for near-ties, its block
    tables and page accounting after every step bitwise, and the ranks'
    lockstep digests equal (the prefix cache: its shared-prefix prompts,
    with hits)."""
    r = runs["ref"][name]
    want_streams, want_snaps = r["serve"][mode]
    prompts = runs["models"][name]["serve"][
        "prefix_prompts" if mode == "prefix" else "ragged"]
    digests = set()
    for rank in runs["ranks"][name]:
        got = rank["serve"][mode]
        for p, g, w in zip(prompts, got["streams"], want_streams):
            _assert_same_or_near_tie(
                np.asarray(g), np.asarray(w), p.size,
                lambda seq: _ref_margin(r["jcfg"], r["jtree"], seq))
        assert got["snaps"] == want_snaps
        digests.add(got["digest"])
    assert len(digests) == 1
    stats = runs["ranks"][name][0]["serve"][mode]["stats"]
    if mode == "mixed":
        assert stats["mixed_steps"] > 0
    if mode == "prefix":
        assert stats["prefix_hits"] > 0


def check_rank_bytes(runs, name):
    """A rank's serving weight bytes are those of ``shard_params`` on the
    full pack, and less than the whole tree's."""
    from repro_torch.distributed.context import Mesh
    cfg = runs["models"][name]["cfg"]
    full = interop.to_torch(runs["models"][name]["serve"]["params"],
                            device="cpu")
    total = texport.memory_report(cfg, full)["bytes"]
    for rank in runs["ranks"][name]:
        local = texport.shard_params(cfg, full, Mesh(
            ("data", "model"), (1, 2), rank["model_rank"]))
        want = texport.memory_report(cfg, local)["bytes"]
        assert rank["serve"]["weight_bytes"] == want < total
