"""The recurrent families served and trained through the port's entry
points, on the CPU, against the reference: ``serve_loop.generate``'s
greedy streams on the rwkv6 and zamba2 smoke models (drawn leaves), with
the pruned-dense and the packed export of the one-shot prune at s = 0.8;
``launch.serve --smoke --device cpu --packed`` rows equal to the JAX
launcher's from the same seeded weights; ``--seal`` then ``--artifact``
(the canaries decode token by token); ``--frontdoor`` refused, as the
reference refuses it; one ``loss_fn`` value and every gradient; the
engine refusing both families; and ``launch.train`` on both smoke
models. A stream may leave the reference's only where the reference's
top-2 margin there is a near-tie (< 1e-5)."""
import contextlib
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _margin  # noqa: E402
from test_torch_rwkv6 import model, one_shot  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import export as jexport  # noqa: E402
from repro.serving import serve_loop as jsl  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import serve_loop as tsl  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-1.2b")
SMALL = ["--smoke", "--prompt-len", "8", "--new-tokens", "6", "--batch",
         "3"]


def _ref_margin(jcfg, jp, seq) -> float:
    """Top-2 margin of the reference's next-token logits after ``seq``,
    through its token-by-token prefill (bf16 cache, as it serves)."""
    last, _ = jsl.prefill_with_decode(jcfg, jp, jnp.asarray(seq)[None],
                                      len(seq))
    return _margin(last[0])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, packed):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = port_cfg(jcfg)
    jp, _ = model(jcfg, 11)
    m = one_shot(jcfg, jp)
    jsv = (jexport.pack_params(jcfg, jp, m) if packed
           else jexport.prune_params(jcfg, jp, m))
    tsv = interop.to_torch(jax.device_get(jsv), device="cpu")
    prompts = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    want, _ = jsl.generate(jcfg, jsv, jnp.asarray(prompts), max_new_tokens=8)
    got, st = tsl.generate(tcfg, tsv, prompts, max_new_tokens=8,
                           device="cpu")
    assert got.shape == (3, 17) and got.dtype == np.int32
    assert st["tok_per_s"] > 0
    for g, w in zip(got, np.asarray(want)):
        _assert_same_or_near_tie(g, w, 9,
                                 lambda s: _ref_margin(jcfg, jsv, s))


def _reference_rows(monkeypatch, argv):
    """The last two token rows the JAX launcher prints for ``argv``."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main()
    monkeypatch.undo()
    rows = buf.getvalue().strip().splitlines()[-2:]
    return [[int(t) for t in re.findall(r"-?\d+", r)] for r in rows]


def _with_reference_params(monkeypatch, arch):
    """Make the port's launcher start from the reference launcher's
    seeded params (``train.step.init_state`` at PRNGKey(0))."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    params = interop.to_torch(jax.device_get(
        jstep.init_state(jcfg, jax.random.PRNGKey(0)).params), device="cpu")
    monkeypatch.setattr(treg, "init_params",
                        lambda cfg, seed, device: params)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_rows_match_the_reference_launcher(arch, monkeypatch):
    argv = ["--arch", arch, "--packed", *SMALL]
    want = _reference_rows(monkeypatch, argv)
    _with_reference_params(monkeypatch, arch)
    res = serve.main([*argv, "--device", "cpu"])
    assert [list(map(int, t)) for t in res["tokens"][:2]] == want
    assert len(res["tokens"]) == 3 and res["memory"]["bytes"] > 0
    assert set(res["seconds"]) == {"init_s", "prune_s", "pack_s"}


@pytest.mark.parametrize("arch", ARCHS)
def test_seal_then_artifact_serves_the_same_rows(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--packed", *SMALL, "--device", "cpu"]
    want = serve.main(argv)["tokens"]
    d = str(tmp_path / "art")
    assert serve.main([*argv, "--seal", d]) is None
    assert f"sealed {d}" in capsys.readouterr().out
    res = serve.main([*argv, "--artifact", d])
    out = capsys.readouterr().out
    n = int(re.search(r"(\d+) canaries replayed", out).group(1))
    assert "artifact OK" in out and n > 0
    for g, w in zip(res["tokens"], want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontdoor_is_refused(arch):
    with pytest.raises(SystemExit, match="engine-servable family"):
        serve.main(["--arch", arch, *SMALL, "--device", "cpu",
                    "--frontdoor"])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_family(arch):
    tcfg = port_cfg(jconfigs.get_config(arch, smoke=True))
    assert not treg.supports_prefill_chunk(tcfg)
    assert not treg.supports_paged(tcfg) and not treg.supports_mixed(tcfg)
    with pytest.raises(NotImplementedError, match="serve_loop.generate"):
        tengine.Engine(tcfg, {}, max_batch=1, max_len=8, device="cpu")


def _port_grads(tcfg, params, masks, batch):
    """(loss, gradient of every leaf by its key path) of ``loss_fn``."""
    leaves = tstep._leaf_params(params)
    loss, _ = tstep.loss_fn(tcfg, leaves, masks, batch)
    loss.backward()
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[path + (k,)] = v.grad.numpy()
    walk(leaves, ())
    return float(loss.detach()), out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """The masked-dense training loss (the launcher's one-shot masks)
    within 1e-5, and the gradient of every leaf. The random rwkv6 smoke
    model is ill-conditioned: weights perturbed by 1e-7 (relative) move
    its gradients by far more than 1e-5 of their magnitude (zamba2's
    stay near it). So each leaf is held within 1e-5 of its magnitude plus
    ten times the port's own gradient change under that perturbation:
    the two packages must agree as well as the function lets any two f32
    evaluations."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = port_cfg(jcfg)
    jp, tp = model(jcfg, 13)
    jm = one_shot(jcfg, jp)
    tm = interop.to_torch(jax.device_get(jm), device="cpu")
    rng = np.random.default_rng(14)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(jcfg, p, jm, jb), has_aux=True))(jp)
    tl, tg = _port_grads(tcfg, tp, tm, tb)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    noisy = adamw.tree_map(
        lambda a: a * (1 + 1e-7 * torch.randn(a.shape, generator=gen)), tp)
    _, tg2 = _port_grads(tcfg, noisy, tm, tb)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    assert len(flat_j) == len(tg)
    for path, g in flat_j:
        key = tuple(k.key for k in path)
        g = np.asarray(g, np.float64)
        got = tg[key].astype(np.float64)
        noise = float(np.abs(tg2[key] - tg[key]).max())
        tol = 1e-5 * max(1.0, float(np.abs(g).max())) + 10 * noise
        err = float(np.abs(got - g).max())
        assert err <= tol, (key, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_the_smoke_model(arch, capsys):
    state, hist = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--seq", "16", "--steps", "6"])
    logged = [h for h in hist if "loss" in h]
    assert state.step == 6 and logged
    assert all(np.isfinite(h["loss"]) for h in logged)
    assert logged[-1]["sparsity"] > 0
    assert "done: final loss" in capsys.readouterr().out
