"""Tensor parallelism on the two-matrix MLP (``mlp2``, the GPT-2 family)
on the CPU: gloo ranks against the reference's single-device functions.

One scenario of 4 ranks, started once (``_torch_dist_rank.py``,
``tp_scenario``; ``_torch_dist_tp.py`` builds the spec and the
reference's answers). Two GPT-2-shaped configs cut to 2 layers, each on
its own (data 1, model 2) pair of ranks:

  * ``odd``: a vocabulary of 257, which does not split over 2, so the
    embedding, the tied head, the greedy argmax and the loss take the
    replicated branch, while the heads and ``w_in``'s 8 block-columns
    split;
  * ``whole``: 3 heads, which do not split (every rank computes all of
    them), and d_ff 48, whose 3 block-columns do not split either: every
    rank computes the whole MLP with ``w_in`` and ``b_in`` whole (d_ff
    itself divides 2, so a ``b_in`` split by its own rule would not fit),
    the packed ``w_out`` still splitting its kept blocks.

On each pair: the training forward of the dense shards (sp off and on)
against the reference's ``forward`` (f32 within 1e-5 of the magnitude);
the packed tree (s = 0.7, f32) served through ``serve_loop.generate``
and the paged ``Engine`` (phased, mixed; ``odd`` also with the prefix
cache) against the reference's streams (near ties below 1e-5 accepted),
next-token logits, block tables and page accounting (bitwise); one train
step with ``sp`` on and off against the reference's ``make_train_step``
(loss and gradient norm to 1e-5 relative, params to 5e-5, masks bitwise)
and the sp step's gradients against ``jax.grad`` (1e-5 of each leaf's
magnitude). Then all four ranks (data 2, model 2) take one step of each
config, sp on and off, and train ``odd`` for two steps through
``train_loop.train``. The norms, biases (``b_in``, ``b_out``) and padded
heads are drawn, so ``b_out`` added before the reduction, or ``b_in``
split while ``w_in`` is whole, misses the bar. The shard layout and the
refusals run in-process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_tp as tp  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.packing import PackedBCSC  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.serving import export as texport  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

NAMES = ("odd", "whole")


def _jcfgs():
    base = dataclasses.replace(jpm.GPT2_SMALL_SMOKE, num_layers=2)
    return {"odd": dataclasses.replace(base, vocab_size=257),
            "whole": dataclasses.replace(base, num_heads=3, num_kv_heads=3,
                                         d_ff=48)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    src = SyntheticLM(257, tp.S, tp.B, seed=1)
    return tp.collect(*tp.start(tmp_path_factory, _jcfgs(), loop="odd",
                                source=src))


@pytest.mark.parametrize("sp", [False, True], ids=["replicated", "sp"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name, sp):
    tp.check_logits(runs, name, sp)


@pytest.mark.parametrize("name", NAMES)
def test_serve_loop_matches_reference(runs, name):
    tp.check_serve_loop(runs, name)


@pytest.mark.parametrize("mode", tp.MODES)
@pytest.mark.parametrize("name", NAMES)
def test_engine_streams_and_pages_match_reference(runs, name, mode):
    tp.check_engine(runs, name, mode)


def test_prefix_cache_engine_matches_reference(runs):
    tp.check_engine(runs, "odd", "prefix")


@pytest.mark.parametrize("name", NAMES)
def test_rank_bytes_are_the_shard(runs, name):
    tp.check_rank_bytes(runs, name)


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_model2_matches_reference(runs, name, sp):
    for r in runs["ranks"][name]:
        tp.check_step(r["m2"][sp], runs["ref"][name]["step"])


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference(runs, name):
    want = runs["ref"][name]["grads"]
    for r in runs["ranks"][name]:
        errs = tp.grad_errs(r["m2"][True]["grads"], want)
        assert max(errs.values()) <= tp.GRAD_REL, errs


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "replicated"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_data2_model2_matches_reference(runs, name, sp):
    for r in runs["all"]:
        tp.check_step(r["d2m2"][name][sp], runs["ref"][name]["step2"])


def test_train_loop_under_mesh(runs):
    """``train_loop.train`` on the (data 2, model 2) mesh: its first loss
    is the reference step's on the same global batch, on every rank."""
    want = runs["ref"]["odd"]["step"]["metrics"]["loss"]
    for r in runs["all"]:
        assert len(r["loop"]) == 2
        assert abs(r["loop"][0] - want) <= tp.RTOL * abs(want)


# ---------------------------------------------------------- in-process
def _full_pack(name):
    cfg = port_cfg(_jcfgs()[name])
    _, npt = tp.weights(_jcfgs()[name], 0)
    return cfg, interop.to_torch(tp.packed(cfg, npt), device="cpu")


@pytest.mark.parametrize("tps", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_mlp2_pack_shard_is_the_nb_nnz_slice(name, tps):
    """``shard_params`` on an mlp2 pack: ``w_in`` is the rank's ``nb``
    slice where its block-columns split (else whole), with ``b_in``
    sliced alike; ``w_out`` the rank's slice of its kept blocks padded
    to a multiple of tp, partial (whole where it keeps fewer blocks a
    column than there are ranks: ``odd`` at tp 4 keeps 3); ``b_out``
    whole; bitwise."""
    from repro_torch.core import packing
    cfg, full = _full_pack(name)
    for r in range(tps):
        local = texport.shard_params(cfg, full, Mesh(("data", "model"),
                                                     (1, tps), r))
        for stack in ("layers",):
            fw, lw = full[stack]["mlp"], local[stack]["mlp"]
            w_in, lin = fw["w_in"], lw["w_in"]
            if w_in.nb % tps == 0:
                n = w_in.nb // tps
                assert torch.equal(lin.blocks,
                                   w_in.blocks[:, r * n:(r + 1) * n])
                assert torch.equal(lin.idx, w_in.idx[:, r * n:(r + 1) * n])
                f = fw["b_in"].shape[-1] // tps
                assert torch.equal(lw["b_in"],
                                   fw["b_in"][:, r * f:(r + 1) * f])
            else:
                assert torch.equal(lin.blocks, w_in.blocks)
                assert torch.equal(lw["b_in"], fw["b_in"])
            assert not lin.partial
            w_out, lout = fw["w_out"], lw["w_out"]
            if w_out.nnz >= tps:
                nnz = -(-w_out.nnz // tps) * tps
                pad = packing.pad_nnz(w_out, nnz)
                n = nnz // tps
                assert lout.partial
                assert torch.equal(lout.blocks,
                                   pad.blocks[:, :, r * n:(r + 1) * n])
                assert torch.equal(lout.idx, pad.idx[:, :, r * n:(r + 1) * n])
            else:                      # fewer kept blocks than ranks
                assert not lout.partial
                assert torch.equal(lout.blocks, w_out.blocks)
            assert torch.equal(lw["b_out"], fw["b_out"])


@pytest.mark.parametrize("name", NAMES)
def test_b_in_splits_where_w_in_splits(name):
    """The train state's layout: ``b_in`` takes ``w_in``'s split of
    d_ff, so ``whole`` (3 block-columns over 2) keeps both whole though
    d_ff 48 divides 2; ``b_out`` replicated; the masks as their
    weights."""
    cfg = port_cfg(_jcfgs()[name])
    mesh = Mesh(("data", "model"), (2, 2), 0)
    sp = sharding.train_specs(cfg, mesh)["params"]["layers"]["mlp"]
    split = name == "odd"
    assert sharding.model_sharded(sp["w_in"]) == split
    assert sharding.model_sharded(sp["w_out"]) == split
    assert sp["b_in"] == sp["w_in"][:1] + sp["w_in"][2:]
    assert not sharding.model_sharded(sp["b_out"])


@pytest.mark.parametrize("seq", [False, True])
def test_partial_flags_name_the_residual_leaves(seq):
    """Under ``seq`` the norms' scales and biases and ``b_out`` (added to
    the S shard) hold partial gradients; ``b_in`` (added to the gathered
    rows) never does."""
    cfg = port_cfg(_jcfgs()["odd"])
    flags = dict(tp.leaves(sharding.partial_flags(cfg, seq)))
    want = set()
    if seq:
        want = {"layers/ln_attn_scale", "layers/ln_attn_bias",
                "layers/ln_mlp_scale", "layers/ln_mlp_bias",
                "layers/mlp/b_out", "ln_f_scale", "ln_f_bias"}
    assert {p for p, f in flags.items() if f} == want


def test_refusals_kept():
    """GPT-2 is admitted, at (data 2, model 2) too (the serving data
    axis); so are ``ssm`` and ``hybrid`` where their heads split, their
    modules taking ``dist=``; heads that do not split stay refused,
    naming the roadmap, by the checks and by the modules themselves."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import check_serving, \
        check_training
    from repro_torch.models import rwkv6, zamba
    d2 = DistContext(Mesh(("data", "model"), (1, 2), 0))
    d22 = DistContext(Mesh(("data", "model"), (2, 2), 0))
    # rwkv6's 48 padded heads and zamba's 4 SSM heads over 5
    d5 = DistContext(Mesh(("data", "model"), (1, 5), 0))
    gpt2 = port_cfg(_jcfgs()["odd"])
    check_training(gpt2, d22)
    check_serving(gpt2, d2)
    check_serving(gpt2, d22)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for arch, mod in (("rwkv6-3b", rwkv6), ("zamba2-1.2b", zamba)):
        cfg = get_config(arch, smoke=True)
        for check in (check_training, check_serving):
            check(cfg, d2)
            check(cfg, d22)
            with pytest.raises(NotImplementedError,
                               match="ROADMAP §1 item 4"):
                check(cfg, d5)
        for call in (lambda: mod.forward(cfg, {}, toks, dist=d5),
                     lambda: mod.decode_step(cfg, {}, {}, toks, 0,
                                             dist=d5)):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP §1 item 4"):
                call()


def test_packs_cross_as_packs():
    """The rank's tree holds ``PackedBCSC`` leaves where the full tree
    does (``interop.to_torch_shard``)."""
    cfg = port_cfg(_jcfgs()["odd"])
    _, npt = tp.weights(_jcfgs()["odd"], 0)
    tree = tp.packed(cfg, npt)
    local = interop.to_torch_shard(tree, cfg, Mesh(("data", "model"),
                                                   (1, 2), 1), device="cpu")
    mlp = local["layers"]["mlp"]
    assert isinstance(mlp["w_in"], PackedBCSC)
    assert isinstance(mlp["w_out"], PackedBCSC) and mlp["w_out"].partial
    assert np.array_equal(mlp["b_out"].numpy(), tree["layers"]["mlp"]["b_out"])
