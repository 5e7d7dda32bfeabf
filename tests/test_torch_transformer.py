"""The port's paged transformer against the reference: chunked prefill
then one decode step, on ``tiny_cfg`` and ``LLAMA32_1B_SMOKE``, with the
serving weights pruned dense and packed. Weights cross through
``interop``. In f32 (f32 pools, so the K/V values are not rounded to
bf16 on either side) at 1e-5; at 1e-4 for LLAMA32_1B_SMOKE, whose K/V
entries grow to about 6 by the fourth layer, where f32 summation-order
differences reach about 1.4e-5 absolute."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import sparse_mlp as jsm  # noqa: E402
from repro.core.prune_grow import initial_mask  # noqa: E402
from repro.models import registry as jreg, transformer as jtr  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.prune_grow import BlastSpec  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def port_cfg(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["blast"] = BlastSpec(**dataclasses.asdict(jcfg.blast))
    return ModelConfig(**d)


def serving_params(jcfg, packed, s=0.8, seed=0):
    """The one-shot magnitude prune of repro/launch/serve.py, then the
    packed or the pruned-dense export; (jax params, port params)."""
    params = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    spec = dataclasses.replace(jcfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in jreg.sparse_paths(jcfg):
        w = jsm.get_path(params, path)
        bi, bo = jsm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        masks[path] = jax.vmap(lambda wi: initial_mask(pspec, wi))(w)
    jp = (jexport.pack_params(jcfg, params, masks) if packed
          else jexport.prune_params(jcfg, params, masks))
    return jp, interop.to_torch(jax.device_get(jp), device="cpu")


CFGS = {"tiny": tiny_cfg, "smoke": lambda: jpm.LLAMA32_1B_SMOKE}
TOLS = {"tiny": TOL, "smoke": dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("name", ["tiny", "smoke"])
def test_prefill_then_decode_logits(name, packed):
    jcfg = CFGS[name]()
    tcfg = port_cfg(jcfg)
    tol = TOLS[name]
    jp, tp = serving_params(jcfg, packed)
    b, c, ps, n_pages = 3, 6, 4, 12
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, c)).astype(np.int32)
    offsets = np.asarray([0, 2, 5], np.int32)
    bt = np.asarray([[0, 1, 2, 11], [3, 4, 5, 11], [6, 7, 8, 11]], np.int32)
    lane_mask = np.asarray([True, True, True])
    jcache = jtr.init_paged_cache(jcfg, n_pages, ps, dtype=jnp.float32)
    tcache = ttr.init_paged_cache(tcfg, n_pages, ps, dtype=torch.float32,
                                  device="cpu")
    jl, jcache = jtr.paged_prefill_chunk(
        jcfg, jp, jcache, jnp.asarray(tokens), 0, jnp.asarray(offsets),
        jnp.asarray(bt), read_pages=2, lane_mask=jnp.asarray(lane_mask))
    tl, tcache = ttr.paged_prefill_chunk(
        tcfg, tp, tcache, torch.from_numpy(tokens), 0,
        torch.from_numpy(offsets), torch.from_numpy(bt), read_pages=2,
        lane_mask=torch.from_numpy(lane_mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **tol)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = np.asarray([c, c, 4 * ps], np.int32)        # lane 2 parked
    jl2, jcache = jtr.paged_decode_step(
        jcfg, jp, jcache, jnp.asarray(nxt), jnp.asarray(pos),
        jnp.asarray(bt), read_pages=2, offsets=jnp.asarray(offsets))
    tl2, tcache = ttr.paged_decode_step(
        tcfg, tp, tcache, torch.from_numpy(nxt), torch.from_numpy(pos),
        torch.from_numpy(bt), read_pages=2,
        offsets=torch.from_numpy(offsets))
    np.testing.assert_allclose(tl2.numpy()[:2], np.asarray(jl2)[:2], **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **tol)


def test_param_specs_match():
    for jcfg in (tiny_cfg(), jpm.LLAMA32_1B, jpm.GPT2_SMALL):
        flat = lambda t: {k: (v.shape, v.init, v.scale)  # noqa: E731
                          for k, v in _flatten(t)}
        assert flat(jtr.param_specs(jcfg)) == flat(
            ttr.param_specs(port_cfg(jcfg)))
        assert jtr.sparse_paths(jcfg) == ttr.sparse_paths(port_cfg(jcfg))


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_export_memory_report_and_joint_marking():
    """pack_params / prune_params / memory_report agree with the
    reference; up masked by gate's mask packs joint on both sides."""
    jcfg = jpm.LLAMA32_1B_SMOKE
    tcfg = port_cfg(jcfg)
    jp, tp = serving_params(jcfg, packed=True)
    assert (jexport.memory_report(jcfg, jp)["bytes"]
            == texport.memory_report(tcfg, tp)["bytes"])
    layer = tp["layers"]["mlp"]
    assert not layer["w_gate"].joint           # magnitude masks differ
    params = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    spec = dataclasses.replace(jcfg.blast, s_init=0.8, s_max=0.8)
    gmask = jax.vmap(lambda w: initial_mask(spec, w))(
        params["layers"]["mlp"]["w_gate"])
    dspec = dataclasses.replace(spec, b_in=spec.b_out, b_out=spec.b_in)
    masks = {"layers/mlp/w_gate": gmask, "layers/mlp/w_up": gmask,
             "layers/mlp/w_down": jax.vmap(lambda w: initial_mask(dspec, w))(
                 params["layers"]["mlp"]["w_down"])}
    jpk = jexport.pack_params(jcfg, params, masks)
    tparams = interop.to_torch(jax.device_get(params), device="cpu")
    tmasks = {k: interop.tensor(np.asarray(v), device="cpu")
              for k, v in masks.items()}
    tpk = texport.pack_params(tcfg, tparams, tmasks)
    for leaf in ("w_gate", "w_up", "w_down"):
        j, t = jpk["layers"]["mlp"][leaf], tpk["layers"]["mlp"][leaf]
        assert j.joint == t.joint == (leaf != "w_down")
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
        np.testing.assert_array_equal(interop.array(t.blocks),
                                      np.asarray(j.blocks))
    tdense = texport.prune_params(tcfg, tparams, tmasks)
    jdense = jexport.prune_params(jcfg, params, masks)
    np.testing.assert_array_equal(
        interop.array(tdense["layers"]["mlp"]["w_down"]),
        np.asarray(jdense["layers"]["mlp"]["w_down"]))


def test_interop_round_trip_is_bit_exact():
    jp, tp = serving_params(CFGS["tiny"](), packed=True)
    back = interop.to_numpy(tp)
    want = jax.device_get(jp)
    mlp, jmlp = back["layers"]["mlp"], want["layers"]["mlp"]
    for leaf in ("w_gate", "w_down"):
        np.testing.assert_array_equal(mlp[leaf]["blocks"],
                                      np.asarray(jmlp[leaf].blocks))
        np.testing.assert_array_equal(mlp[leaf]["idx"],
                                      np.asarray(jmlp[leaf].idx))
        assert (mlp[leaf]["kb"], mlp[leaf]["joint"]) == (jmlp[leaf].kb,
                                                         jmlp[leaf].joint)
    assert back["embed"].dtype == np.asarray(want["embed"]).dtype
    np.testing.assert_array_equal(back["embed"], np.asarray(want["embed"]))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_mlp2_matches(packed):
    """The GPT-2 two-matrix MLP (gelu, biases), dense and packed."""
    from repro.core import sparse_mlp as jsm_
    from repro_torch.core import sparse_mlp as tsm
    jcfg = jpm.GPT2_SMALL_SMOKE
    jp, tp = serving_params(jcfg, packed)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
    tl = ttr._layer_view(tp["layers"], 0)["mlp"]
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    want = jsm_.mlp2(jnp.asarray(x), jl["w_in"], jl["w_out"], jl["b_in"],
                     jl["b_out"], act="gelu")
    got = tsm.mlp2(torch.from_numpy(x), tl["w_in"], tl["w_out"], tl["b_in"],
                   tl["b_out"], act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pack_params_unbalanced_masks():
    """Global (unbalanced) masks pad with zero blocks: warn by default,
    raise on request, report the pad fraction the reference reports."""
    jcfg = tiny_cfg()
    tcfg = port_cfg(jcfg)
    params = jreg.init_params(jcfg, jax.random.PRNGKey(2))
    spec = dataclasses.replace(jcfg.blast, s_init=0.75, selection="global")
    masks = {}
    for path in jreg.sparse_paths(jcfg):
        bi, bo = jsm.block_dims_for(spec, path)
        pspec = dataclasses.replace(spec, b_in=bi, b_out=bo)
        masks[path] = jax.vmap(lambda w: initial_mask(pspec, w))(
            jsm.get_path(params, path))
    tparams = interop.to_torch(jax.device_get(params), device="cpu")
    tmasks = {k: interop.tensor(np.asarray(v), device="cpu")
              for k, v in masks.items()}
    jrep, trep = {}, {}
    with pytest.warns(jexport.UnbalancedMaskWarning):
        jpk = jexport.pack_params(jcfg, params, masks, pad_report=jrep)
    with pytest.warns(texport.UnbalancedMaskWarning):
        tpk = texport.pack_params(tcfg, tparams, tmasks, pad_report=trep)
    assert trep == pytest.approx(jrep) and trep
    for path in masks:
        j, t = jsm.get_path(jpk, path), jsm.get_path(tpk, path)
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
        np.testing.assert_array_equal(interop.array(t.blocks),
                                      np.asarray(j.blocks))
    with pytest.raises(ValueError, match="unbalanced"):
        texport.pack_params(tcfg, tparams, tmasks, unbalanced="raise")
