"""The port's sharding rules and per-rank packs against the reference's.

``spec_for``, ``batch_sharding``, ``cache_sharding`` and
``abstract_packed_params`` against ``repro/distributed/sharding.py`` and
``repro/serving/export.py`` under hypothesis draws of shapes, logical
axes and mesh sizes (1, 2, 4, 8, 16 and 2 x 16). The reference reads only
``mesh.axis_names`` and ``mesh.devices.shape``, so a namespace with
``devices=np.empty(shape)`` stands in for a mesh of that size; where it
wraps a spec in a ``NamedSharding`` (which wants real devices) the test
takes the spec out instead. Then the per-rank packs: on ``tiny_cfg`` and
``LLAMA32_1B_SMOKE`` at tp 1, 2 and 4 the ranks' shards of the
reference's ``pack_params`` output reassemble into it bitwise, padding
removed, and every other leaf into the full leaf; the edge cases each
their own case: a down pack with fewer kept blocks than ranks
(replicated), gate/up column-blocks that the model axis does not divide
(replicated), kv heads and a vocabulary that it does not divide. Last,
the mesh constructors on a one-rank gloo group.
"""
import contextlib
import dataclasses
import types

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
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.packing import PackedBCSC  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover
    from _hypo import given, settings, strategies as st

MESHES = [(("data", "model"), (1, n)) for n in (1, 2, 4, 8, 16)] + [
    (("data", "model"), (2, 16)), (("pod", "data", "model"), (2, 2, 4))]
AXES = list(tshd.DEFAULT_RULES) + ["embed", "head_dim", "layers", None]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256]


def _ns(names, shape):
    """A stand-in mesh for both packages."""
    return types.SimpleNamespace(axis_names=names, shape=shape,
                                 devices=np.empty(shape))


@contextlib.contextmanager
def _spec_only():
    """The reference's ``NamedSharding`` reduced to its spec."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jshd, jax.sharding):
            mp.setattr(mod, "NamedSharding", lambda mesh, spec: tuple(spec))
        yield


@settings(max_examples=200, deadline=None)
@given(mesh=st.sampled_from(MESHES),
       dims=st.lists(st.tuples(st.sampled_from(DIMS), st.sampled_from(AXES)),
                     min_size=1, max_size=5))
def test_spec_for_matches_reference(mesh, dims):
    m = _ns(*mesh)
    shape = tuple(d for d, _ in dims)
    axes = tuple(a for _, a in dims)
    assert tshd.spec_for(shape, axes, m) == tuple(
        jshd.spec_for(shape, axes, m))


@settings(max_examples=100, deadline=None)
@given(mesh=st.sampled_from(MESHES), ndim=st.integers(1, 5),
       batch=st.sampled_from([None] + DIMS),
       cache=st.tuples(*[st.sampled_from(DIMS)] * 5),
       seq_axis=st.integers(1, 4))
def test_batch_and_cache_sharding_match_reference(mesh, ndim, batch, cache,
                                                  seq_axis):
    m = _ns(*mesh)
    with _spec_only():
        assert tshd.batch_sharding(m, ndim, batch) == jshd.batch_sharding(
            m, ndim, batch)
        assert tshd.cache_sharding(m, cache, seq_axis) == \
            jshd.cache_sharding(m, cache, seq_axis)
    assert tshd.batch_pspec(m) == tuple(jshd.batch_pspec(m))


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("name", ["tiny", "smoke", "llama"])
def test_abstract_packed_params_match_reference(name, tp):
    jcfg = {"tiny": tiny_cfg(), "smoke": jpm.LLAMA32_1B_SMOKE,
            "llama": jpm.LLAMA32_1B}[name]
    m = _ns(("data", "model"), (1, tp))
    with _spec_only():
        jabs, jspecs = jexport.abstract_packed_params(jcfg, 0.8, m)
    tabs, tspecs = texport.abstract_packed_params(port_cfg(jcfg), 0.8, m)
    for path in jreg.sparse_paths(jcfg):
        jp, tp_ = jsm.get_path(jabs, path), jsm.get_path(tabs, path)
        assert tuple(tp_.blocks.shape) == jp.blocks.shape
        assert tuple(tp_.idx.shape) == jp.idx.shape
        js, ts = jsm.get_path(jspecs, path), jsm.get_path(tspecs, path)
        assert ts.blocks == js.blocks and ts.idx == js.idx
    # every other leaf: the same spec
    for path, spec in _flat(tspecs):
        if path not in jreg.sparse_paths(jcfg):
            assert spec == jsm.get_path(jspecs, path), path


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ------------------------------------------------------- per-rank packs
def _masked(jcfg, s):
    """Port-seeded params and the launcher's one-shot masks at ``s``
    (port side: the reference's init and prune would compile for
    seconds, and its pack below is handed the same arrays)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask as t_initial_mask
    cfg = port_cfg(jcfg)
    params = treg.init_params(cfg, 0, device="cpu")
    spec = dataclasses.replace(cfg.blast, s_init=s, s_max=s)
    masks = {}
    for path in treg.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = t_initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return cfg, params, masks


def _reference_pack(jcfg, s=0.8):
    """The reference's ``pack_params`` output (bf16), in the port's
    types."""
    _, params, masks = _masked(jcfg, s)
    jp = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(params))
    jm = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    return interop.to_torch(jax.device_get(
        jexport.pack_params(jcfg, jp, jm)), device="cpu")


def _port_pack(jcfg, s=0.8):
    cfg, params, masks = _masked(jcfg, s)
    return texport.pack_params(cfg, params, masks)


@pytest.fixture(scope="module")
def packs():
    return {"tiny": (tiny_cfg(), _reference_pack(tiny_cfg())),
            "smoke": (jpm.LLAMA32_1B_SMOKE,
                      _reference_pack(jpm.LLAMA32_1B_SMOKE, 0.7))}


def _ranks(cfg, tree, tp):
    return [texport.shard_params(cfg, tree, Mesh(("data", "model"), (1, tp),
                                                 r)) for r in range(tp)]


def _reassemble(path, full, parts, spec):
    """Concatenate the ranks' leaves along the split dims; a pack along
    ``nb`` or ``nnz``, its padding cut off. Returns the whole leaf."""
    if isinstance(full, PackedBCSC):
        b0 = parts[0]
        if b0.nb < full.nb:                                 # split nb
            return PackedBCSC(torch.cat([p.blocks for p in parts], -4),
                              torch.cat([p.idx for p in parts], -2),
                              b0.kb, b0.joint)
        if b0.partial:                                      # split nnz
            blocks = torch.cat([p.blocks for p in parts], -3)
            idx = torch.cat([p.idx for p in parts], -1)
            return PackedBCSC(blocks[..., :full.nnz, :, :],
                              idx[..., :full.nnz], b0.kb, b0.joint)
        for p in parts:
            assert torch.equal(p.blocks, full.blocks), path
        return b0
    out = parts[0]
    for dim, entry in enumerate(spec):
        if entry is not None:
            out = torch.cat(parts, dim)
    return out


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", ["tiny", "smoke"])
def test_rank_packs_reassemble_reference_pack(packs, name, tp):
    jcfg, tree = packs[name]
    cfg = port_cfg(jcfg)
    parts = _ranks(cfg, tree, tp)
    specs = tshd.param_specs_tree(treg.param_specs(cfg),
                                  _ns(("data", "model"), (1, tp)))
    for path, full in _leaves(tree):
        got = _reassemble(path, full, [jsm.get_path(p, path)
                                       for p in parts],
                          jsm.get_path(specs, path))
        if isinstance(full, PackedBCSC):
            assert torch.equal(got.blocks, full.blocks), path
            assert torch.equal(got.idx, full.idx), path
            assert got.joint == full.joint and got.kb == full.kb
            for p in parts:
                q = jsm.get_path(p, path)
                assert q.blocks.is_contiguous() and q.idx.is_contiguous()
        else:
            assert torch.equal(got, full), path


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_down_pack_nnz_split_pads_with_zero_blocks(packs):
    """smoke at s = 0.7 keeps 3 down blocks a column: tp 2 pads to 4
    (the pad a zero block at idx 0 on the last rank) and marks both
    shares partial."""
    jcfg, tree = packs["smoke"]
    full = tree["layers"]["mlp"]["w_down"]
    assert full.nnz == 3
    a, b = [p["layers"]["mlp"]["w_down"] for p in
            _ranks(port_cfg(jcfg), tree, 2)]
    assert a.nnz == b.nnz == 2 and a.partial and b.partial
    assert torch.equal(b.idx[..., 1], torch.zeros_like(b.idx[..., 1]))
    assert not b.blocks[..., 1, :, :].any()


@pytest.mark.parametrize("case", ["down_nnz_below_tp", "nb_not_divisible",
                                  "kv_heads_not_divisible",
                                  "vocab_not_divisible"])
def test_edge_cases_replicate(packs, case):
    """Where the model axis does not divide a dim, its leaf stays whole
    on every rank (and a pack is not partial)."""
    if case == "down_nnz_below_tp":           # 3 kept blocks, 4 ranks
        jcfg, tree = packs["smoke"]
        tp, path = 4, "layers/mlp/w_down"
    elif case == "nb_not_divisible":          # 6 column-blocks, 4 ranks
        jcfg = tiny_cfg(d_ff=96)
        tree = _port_pack(jcfg)
        tp, path = 4, "layers/mlp/w_gate"
    elif case == "kv_heads_not_divisible":    # 2 kv heads, 4 ranks
        jcfg = tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64, d_ff=128)
        tree = _port_pack(jcfg)
        tp, path = 4, "layers/attn/wk"
    else:                                     # 62 tokens, 4 ranks
        jcfg = tiny_cfg(vocab_size=62)
        tree = _port_pack(jcfg)
        tp, path = 4, "embed"
    full = jsm.get_path(tree, path)
    for part in _ranks(port_cfg(jcfg), tree, tp):
        got = jsm.get_path(part, path)
        if isinstance(full, PackedBCSC):
            assert not got.partial
            assert torch.equal(got.blocks, full.blocks)
            assert torch.equal(got.idx, full.idx)
        else:
            assert torch.equal(got, full)
    if case == "kv_heads_not_divisible":      # the query heads still split
        q = jsm.get_path(_ranks(port_cfg(jcfg), tree, tp)[1],
                         "layers/attn/wq")
        assert q.shape[-2] == 1


def test_mask_sharding_tree_slices_like_the_weights():
    cfg = port_cfg(tiny_cfg(num_heads=4, num_kv_heads=2, d_model=64,
                            d_ff=128))
    params = treg.init_params(cfg, 0, device="cpu")
    masks = treg.init_masks(cfg, params)
    masks = {k: torch.rand(v.shape, generator=torch.Generator().manual_seed(
        1)) < 0.5 for k, v in masks.items()}
    axes = treg.axes_tree(cfg)
    paths = treg.sparse_paths(cfg)
    parts = [tshd.mask_sharding_tree(masks, axes, paths,
                                     Mesh(("data", "model"), (1, 2), r))
             for r in range(2)]
    for path in paths:
        dim = 2 if path.endswith(("w_gate", "w_up")) else 1   # the ff dim
        assert torch.equal(torch.cat([p[path] for p in parts], dim),
                           masks[path])
        assert parts[0][path].shape[dim] * 2 == masks[path].shape[dim]
    local = tshd.param_sharding_tree(params, treg.param_specs(cfg),
                                     Mesh(("data", "model"), (1, 2), 1))
    assert local["layers"]["mlp"]["w_gate"].shape[-1] == cfg.d_ff // 2
    assert tshd.count_bytes(local) < tshd.count_bytes(params)


def test_mesh_constructors_on_one_rank(tmp_path):
    import torch.distributed as tdist
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group)
    from repro_torch.launch import mesh as lmesh
    init_process_group(str(tmp_path), 0, 1)
    try:
        m = lmesh.make_host_mesh()
        assert (m.axis_names, m.shape, m.coords) == (
            ("data", "model"), (1, 1), {"data": 0, "model": 0})
        with pytest.raises(ValueError, match="256"):
            lmesh.make_production_mesh()
        with pytest.raises(ValueError, match="512"):
            lmesh.make_production_mesh(multi_pod=True)
        d = DistContext(m)
        x = torch.arange(6.0).reshape(2, 3)
        assert d.tp == 1 and d.all_reduce(x) is x
        assert d.batch_axes == ("data",)
        assert d.batch_pspec(3) == ("data", None, None)
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("name", ["tiny", "llama"])
def test_helpers_dist_reads_match_reference(name):
    """``ParallelConfig.batch_axes``, ``registry.axes_tree`` and
    ``registry.abstract_cache`` against the reference's."""
    from repro.configs.base import ParallelConfig as JPar
    from repro_torch.configs.base import ParallelConfig as TPar
    jcfg = {"tiny": tiny_cfg(), "llama": jpm.LLAMA32_1B}[name]
    cfg = port_cfg(jcfg)
    for kw in ({}, {"pod_axis": "pod"}, {"data_axes": ("a", "b")}):
        assert TPar(**kw).batch_axes == JPar(**kw).batch_axes
    assert dict(_flat(treg.axes_tree(cfg))) == dict(_flat(
        jreg.axes_tree(jcfg)))
    jc = jreg.abstract_cache(jcfg, 3, 40)
    tc = treg.abstract_cache(cfg, 3, 40)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape and tc[k].dtype == torch.bfloat16


def test_mesh_coords_are_row_major():
    m = Mesh(("pod", "data", "model"), (2, 2, 4), rank=13)
    assert m.coords == {"pod": 1, "data": 1, "model": 1}
    assert m.axis_size("model") == 4 and m.axis_size("seq") == 1
