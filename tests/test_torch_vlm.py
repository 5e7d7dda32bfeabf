"""The VLM family (internvl2-2b, ``vlm``: the transformer with patch
embeddings) in the port against the reference on the smoke config (8
patches, GQA 4 over 2, rope) on the same weights: ``embed_inputs`` with
and without patches (bitwise), the training ``forward(patch_embeds=)``
dense, with the one-shot masks and packed (the fused GLU and ``bspmm``
through their plain versions), the patches moving every position's
logits, ``loss_fn`` and every gradient with ``patch_embeds``; through the
entry points, ``launch.serve --arch internvl2-2b --smoke --device cpu
--packed`` printing the reference launcher's token rows (the engine
serves text only, as the reference's does), a sealed artifact serving
the same rows, the front door, and ``launch.train`` exiting on the
patch embeddings its token sources lack. Weights cross from the port's
seeded init with drawn norms (``test_torch_whisper.model``). f32 within
1e-5 of the output's magnitude."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_rwkv6 import _close, _t  # noqa: E402
from test_torch_ssm_serving import (SMALL, _reference_rows,  # noqa: E402
                                    _with_reference_params)
from test_torch_transformer import port_cfg  # noqa: E402
from test_torch_whisper import exports, model  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

ARCH = "internvl2-2b"
B, S = 2, 24


def _cfgs():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    return jcfg, port_cfg(jcfg)


def _inputs(jcfg, seed):
    """(tokens (B, S), patch embeddings (B, num_patches, D): seeded
    normals x 0.02)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pe = (rng.standard_normal((B, jcfg.num_patches, jcfg.d_model))
          * 0.02).astype(np.float32)
    return toks, pe


def test_embed_inputs_with_and_without_patches():
    jcfg, tcfg = _cfgs()
    jp, tp = model(jcfg, 1)
    toks, pe = _inputs(jcfg, 2)
    assert tcfg.num_patches == 8
    for patches in (None, pe):
        want = jtr.embed_inputs(jcfg, jp, jnp.asarray(toks),
                                None if patches is None
                                else jnp.asarray(patches))
        got = ttr.embed_inputs(tcfg, tp, _t(toks),
                               None if patches is None else _t(patches))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ttr.embed_inputs(tcfg, tp, _t(toks), _t(pe)).numpy()
    np.testing.assert_array_equal(got[:, :8], pe)
    np.testing.assert_array_equal(
        got[:, 8:], ttr.embed_inputs(tcfg, tp, _t(toks))[:, 8:].numpy())


@pytest.mark.parametrize("kind", ["dense", "masks", "packed"])
def test_forward_with_patch_embeds(kind):
    jcfg, tcfg = _cfgs()
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 3)[0], kind)
    toks, pe = _inputs(jcfg, 4)
    want, _ = jreg.forward(jcfg, jp, jnp.asarray(toks), masks=jm,
                           patch_embeds=jnp.asarray(pe))
    got, aux = treg.forward(tcfg, tp, _t(toks), masks=tm,
                            patch_embeds=_t(pe))
    assert float(aux) == 0.0
    _close(got.numpy(), want)


def test_patches_move_the_logits():
    """Patches replace the first ``num_patches`` token embeddings, so
    every position's logits move (the text positions through causal
    attention); without patches the forward is the text-only one."""
    jcfg, tcfg = _cfgs()
    _, tp = model(jcfg, 5)
    toks, pe = _inputs(jcfg, 6)
    with_p, _ = treg.forward(tcfg, tp, _t(toks), patch_embeds=_t(pe))
    text, _ = treg.forward(tcfg, tp, _t(toks))
    moved = (with_p - text).abs().amax(dim=-1)
    assert bool((moved > 1e-3 * text.abs().max()).all()), moved
    other, _ = treg.forward(tcfg, tp, _t(toks),
                            patch_embeds=_t(pe[::-1].copy()))
    assert not torch.equal(other, with_p)


def test_loss_and_gradients_with_patch_embeds():
    """The masked-dense training loss with patch embeddings and the
    gradient of every leaf, each within 1e-5 of its magnitude."""
    jcfg, tcfg = _cfgs()
    jp, tp, jm, tm = exports(jcfg, model(jcfg, 7)[0], "masks")
    toks, pe = _inputs(jcfg, 8)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "patch_embeds": jnp.asarray(pe)}
    tb = {"tokens": _t(toks), "labels": _t(labels), "patch_embeds": _t(pe)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(jcfg, p, jm, jb), has_aux=True))(jp)
    leaves = tstep._leaf_params(tp)
    tl, _ = tstep.loss_fn(tcfg, leaves, tm, tb)
    tg = torch.autograd.grad(tl, adamw.tree_leaves(leaves))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    flat_j = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(flat_j) == len(tg)
    for g, want in zip(tg, flat_j):
        _close(g.numpy(), want)


def test_launcher_rows_match_the_reference_launcher(monkeypatch):
    argv = ["--arch", ARCH, "--packed", *SMALL]
    want = _reference_rows(monkeypatch, argv)
    _with_reference_params(monkeypatch, ARCH)
    res = serve.main([*argv, "--device", "cpu"])
    assert [list(map(int, t)) for t in res["tokens"][:2]] == want
    assert len(res["tokens"]) == 3 and res["memory"]["bytes"] > 0
    assert res["stats"]["generated_tokens"] == 18


def test_seal_artifact_and_frontdoor(tmp_path, capsys):
    argv = ["--arch", ARCH, "--packed", *SMALL, "--device", "cpu"]
    want = serve.main(argv)["tokens"]
    d = str(tmp_path / "art")
    assert serve.main([*argv, "--seal", d]) is None
    res = serve.main([*argv, "--artifact", d])
    out = capsys.readouterr().out
    assert "artifact OK" in out
    assert int(re.search(r"(\d+) canaries replayed", out).group(1)) > 0
    for g, w in zip(res["tokens"], want):
        np.testing.assert_array_equal(g, w)
    st = serve.main([*argv, "--frontdoor", "--n-inter", "2",
                     "--inter-gap-s", "0.05"])["stats"]
    assert st["generated_tokens"] == 3 * 6 + 2 * 8


def test_train_launcher_exits_on_missing_patch_embeds(monkeypatch):
    from repro_torch.training import train_loop

    def never(*a, **k):
        raise AssertionError("trained without patch embeddings")
    monkeypatch.setattr(treg, "init_params", never)
    monkeypatch.setattr(train_loop, "train", never)
    with pytest.raises(SystemExit, match="'patch_embeds'"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2"])


def test_carried_state_trains_one_step_with_patches():
    """One train step of each trainer with ``patch_embeds`` in the batch
    from one carried reference state: the loss within 1e-5."""
    from test_torch_train import _opt
    jcfg, tcfg = _cfgs()
    jopt, topt = _opt()
    js = jstep.init_state(jcfg, jax.random.PRNGKey(9))
    ts = interop.train_state(jax.device_get(js), device="cpu")
    toks, pe = _inputs(jcfg, 10)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "patch_embeds": jnp.asarray(pe)}
    tb = {"tokens": _t(toks), "labels": _t(labels), "patch_embeds": _t(pe)}
    js, jmet = jax.jit(jstep.make_train_step(jcfg, jopt))(js, jb)
    ts, tmet = tstep.make_train_step(tcfg, topt)(ts, tb)
    assert ts.step == int(js.step) == 1
    assert tmet["loss"] == pytest.approx(float(jmet["loss"]), rel=1e-5)
