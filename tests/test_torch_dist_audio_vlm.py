"""Tensor parallelism on the ``audio`` (whisper) and ``vlm`` (internvl2)
families on the CPU: gloo ranks against the reference's single-device
functions.

One scenario of 4 ranks, started once (``_torch_dist_rank.py``,
``tp_scenario``; ``_torch_dist_tp.py`` builds the spec and the
reference's answers): ranks 0-1 run whisper-large-v3's smoke config (4
query heads over 2 kv heads, padded to 32 query heads: rank 0 holds the
4 live ones and rank 1 only padded ones; 2 encoder and 4 decoder
layers), ranks 2-3 internvl2-2b's (8 patches), each at (data 1, model
2). On each pair: the training forward of the dense shards with
whisper's frames (S_enc 10) or the VLM's patch embeddings, sp off and on
(at S 12 rank 0's shard holds patches 0-5 and rank 1's patches 6-7,
which must land there and not on its own first tokens), against the
reference's ``forward`` (f32 within 1e-5 of the magnitude); the packed
tree (s = 0.7, f32) served: whisper's ``prefill_cross`` (each rank's
cross K/V are its kv head of the reference's) and
``serve_loop.generate(frames=)``, the VLM's text through
``serve_loop.generate`` and the paged ``Engine`` (phased, mixed,
prefix-cached),
against the reference's streams (near ties below 1e-5 accepted), block
tables and page accounting (bitwise); one train step with ``sp`` on and
off against the reference's ``make_train_step`` with frames or patches
in the batch (loss and gradient norm to 1e-5 relative, params to 5e-5,
masks bitwise) and the sp step's gradients against ``jax.grad``. Then
all four ranks (data 2, model 2) take one step of each, sp on and off
(the frames and patches cut by data rank with the tokens; whisper's
frames at S_enc 9, which does not split, so the encoder's stream stays
whole while the decoder's splits). The norms, biases and padded heads
are drawn. Whisper's learned positions are added to the whole sequence
before the split, so their gradient is whole
(``sharding.partial_flags``); the padded heads and the layouts run
in-process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_tp as tp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from test_torch_rwkv6 import _close  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

NAMES = ("whisper", "vlm")


def _jcfgs():
    return {"whisper": jconfigs.get_config("whisper-large-v3", smoke=True),
            "vlm": jconfigs.get_config("internvl2-2b", smoke=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.collect(*tp.start(tmp_path_factory, _jcfgs()))


@pytest.mark.parametrize("sp", [False, True], ids=["replicated", "sp"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name, sp):
    tp.check_logits(runs, name, sp)


@pytest.mark.parametrize("name", NAMES)
def test_serve_loop_matches_reference(runs, name):
    tp.check_serve_loop(runs, name)


def test_prefill_cross_holds_the_ranks_kv_heads(runs):
    """Each rank's cross K/V (layers, B, S_enc, 1, hd) is its kv head of
    the reference's ``prefill_cross``."""
    want = runs["ref"]["whisper"]["serve"]
    for r in runs["ranks"]["whisper"]:
        k = r["model_rank"]
        for key in ("ck", "cv"):
            got = r["serve"][key]
            assert got.shape[3] == 1
            _close(got, want[key][:, :, :, k:k + 1])


@pytest.mark.parametrize("mode", tp.MODES + ("prefix",))
def test_engine_streams_and_pages_match_reference(runs, mode):
    tp.check_engine(runs, "vlm", mode)


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


# ---------------------------------------------------------- in-process
def _mha_like_large():
    """whisper-large-v3's head layout on the smoke widths: 20 heads over
    20 kv heads, padded to 32 (MHA: the kv heads pad too)."""
    import dataclasses
    return dataclasses.replace(_jcfgs()["whisper"], num_heads=20,
                               num_kv_heads=20)


@pytest.mark.parametrize("tps", [2, 4])
def test_zero_padded_heads_on_a_shard(tps):
    """``zero_padded_heads`` on each rank's shard of a drawn tree equals
    the shard of the zeroed whole tree, bitwise: at model 2 rank 0 keeps
    its 16 heads, rank 1 zeroes 12 of its 16; every padded head is zero
    and no live one is."""
    jcfg = _mha_like_large()
    cfg = port_cfg(jcfg)
    _, npt = tp.weights(jcfg, 0)    # drawn: the padded heads are live
    whole = interop.to_torch(npt, device="cpu")
    zeroed = interop.to_torch(npt, device="cpu")
    treg.module_for(cfg).zero_padded_heads(cfg, zeroed)
    for r in range(tps):
        mesh = Mesh(("data", "model"), (1, tps), r)
        dist = DistContext(mesh)
        shd = sharding.state_shardings(cfg, mesh).params
        local = sharding.shard_tree(whole, shd)
        treg.module_for(cfg).zero_padded_heads(cfg, local, dist)
        want = sharding.shard_tree(zeroed, shd)
        first, n, _, _ = tattn.local_heads(cfg, dist)
        for stack, block in (("encoder", "attn"), ("decoder", "attn"),
                             ("decoder", "cross")):
            got, w = local[stack][block], want[stack][block]
            for leaf in ("wq", "wo"):
                assert torch.equal(got[leaf], w[leaf])
            live = max(0, min(cfg.num_heads - first, n))
            assert not got["wq"][..., live:, :].any()
            assert got["wq"][..., :live, :].abs().amax(dim=(0, 1, 3)).gt(
                0).all()


def test_partial_flags_follow_each_stream():
    """Whisper's encoder leaves and its final norm follow the encoder's
    split, the rest the decoder's; the learned positions and ``b_in``
    are never partial."""
    cfg = port_cfg(_jcfgs()["whisper"])

    def flagged(seq, seq_enc):
        return {p for p, f in tp.leaves(sharding.partial_flags(
            cfg, seq, seq_enc)) if f}
    enc = {p for p in flagged(True, True) if p.startswith(("encoder/",
                                                           "ln_enc_f"))}
    dec = flagged(True, True) - enc
    assert flagged(True, False) == dec and flagged(False, True) == enc
    assert flagged(False, False) == set()
    assert "decoder/mlp/b_out" in dec and "decoder/ln_cross_bias" in dec
    assert {"encoder/mlp/b_out", "ln_enc_f_scale", "ln_enc_f_bias"} <= enc
    assert not {p for p in flagged(True, True)
                if p.startswith("pos_") or p.endswith("b_in")}


def test_whisper_layout_at_model2():
    """The train state and the serving shards of whisper's nested
    stacks: the heads (padded to 32) and ``w_in``'s block-columns split,
    ``b_in`` with them, the cross K/V projections of the rank's kv
    heads, the untied head on the vocabulary, positions and norms
    replicated; the decode caches of the rank's kv heads."""
    from repro_torch.serving import export as texport
    cfg = port_cfg(_jcfgs()["whisper"])
    mesh = Mesh(("data", "model"), (2, 2), 0)
    sp = sharding.train_specs(cfg, mesh)["params"]
    for stack in ("encoder", "decoder"):
        mlp = sp[stack]["mlp"]
        assert mlp["w_in"][-1] == "model" and mlp["b_in"][-1] == "model"
        assert not sharding.model_sharded(mlp["b_out"])
    assert sp["decoder"]["cross"]["wk"] == (None, None, "model", None)
    assert sp["lm_head"] == (None, "model")
    for leaf in ("pos_enc", "pos_dec", "ln_enc_f_scale", "ln_f_bias"):
        assert not sharding.model_sharded(sp[leaf])
    _, npt = tp.weights(_jcfgs()["whisper"], 0)
    tree = interop.to_torch(tp.packed(cfg, npt), device="cpu")
    local = texport.shard_params(cfg, tree, Mesh(("data", "model"),
                                                 (1, 2), 1))
    for stack in ("encoder", "decoder"):
        w, lw = tree[stack]["mlp"], local[stack]["mlp"]
        assert lw["w_in"].nb * 2 == w["w_in"].nb
        assert lw["b_in"].shape[-1] * 2 == w["b_in"].shape[-1]
        assert lw["w_out"].partial
        assert torch.equal(lw["b_out"], w["b_out"])
    assert local["decoder"]["cross"]["wk"].shape[-2] == 1
    d2 = DistContext(Mesh(("data", "model"), (1, 2), 1))
    cache = treg.abstract_cache(cfg, 3, 16, dist=d2, enc_len=10)
    assert cache["k"].shape == (cfg.num_layers, 3, 16, 1, cfg.head_dim)
    assert cache["ck"].shape == (cfg.num_layers, 3, 10, 1, cfg.head_dim)
    assert treg.init_cache(cfg, 3, 16, dist=d2, device="cpu")["v"].shape \
        == cache["v"].shape
    full = np.asarray(tree["pos_dec"])
    assert np.array_equal(np.asarray(local["pos_dec"]), full)
