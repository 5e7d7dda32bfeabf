"""The port's sealed artifacts (``repro_torch/serving/artifact.py``)
through the cases of the reference's ``tests/test_artifact.py``: a
seal/validate/load round trip is bitwise, the canaries replay, every
``ARTIFACT_FAULTS`` corruption is caught by its layer with its typed
error (the class named as the reference's on the same corruption of a
reference-sealed artifact), a one-bit flip in any array is caught, and
export's pad fractions are recorded. Across packages: the fingerprints
are equal; an artifact the JAX package sealed validates and loads in the
port, its leaves bitwise equal to the sealed ones and its canaries
replayed within the cross-package gate (0 token mismatches, logit drift
<= 1e-4); one the port sealed passes the JAX ``validate`` and ``load``;
the two manifests agree on every array's crc32 but the canary logits';
``structure_violations`` returns the reference's strings. Within the
port, canary logits replay bitwise (gate 0.0). Models are ``tiny_cfg``
in f32, bf16 where named."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import packing as jpacking, sparse_mlp as jsm, topk  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import artifact as jart, export as jexport  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_models as tpm  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serving import artifact as tart, export as texport  # noqa: E402
from repro_torch.serving.faults import ARTIFACT_FAULTS, FaultPlan  # noqa: E402
from test_torch_train import port_cfg  # noqa: E402

CROSS_DRIFT = 1e-4


def _masks(cfg, params, keep_frac=0.5):
    masks = {}
    for path in jreg.sparse_paths(cfg):
        w = jsm.get_path(params, path)
        bi, bo = jsm.block_dims_for(cfg.blast, path)

        def mk(wi):
            s = topk.block_norms(wi, bi, bo)
            kb = wi.shape[-2] // bi
            return topk.topk_mask_per_col(s, max(1, int(kb * keep_frac)))

        fn = mk
        for _ in range(w.ndim - 2):
            fn = jax.vmap(fn)
        masks[path] = fn(w)
    return masks


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, JAX params, port params, masks), packed in f32."""
    jcfg = tiny_cfg()
    params = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    masks = _masks(jcfg, params)
    jp = jexport.pack_params(jcfg, params, masks, dtype=jnp.float32)
    return (jcfg, port_cfg(jcfg), jp,
            interop.to_torch(jax.device_get(jp), device="cpu"), params, masks)


@pytest.fixture(scope="module")
def sealed(model, tmp_path_factory):
    """A port-sealed and a JAX-sealed artifact of the same weights."""
    jcfg, tcfg, jp, tp = model[:4]
    root = tmp_path_factory.mktemp("artifact")
    td, jd = str(root / "port"), str(root / "jax")
    return td, tart.seal(tcfg, tp, td), jd, jart.seal(jcfg, jp, jd)


@pytest.fixture(scope="module")
def sealed_bf16(model, tmp_path_factory):
    """The same, packed in bf16 (stored as uint16 bit patterns)."""
    jcfg, tcfg, _, _, params, masks = model
    jp = jexport.pack_params(jcfg, params, masks, dtype=jnp.bfloat16)
    tp = interop.to_torch(jax.device_get(jp), device="cpu")
    root = tmp_path_factory.mktemp("artifact_bf16")
    td, jd = str(root / "port"), str(root / "jax")
    return td, tart.seal(tcfg, tp, td), jd, jart.seal(jcfg, jp, jd)


def _flat(params):
    return {k: interop.array(v)
            for k, v in tart._flatten_params(params)[0].items()}


def test_seal_validate_load_roundtrip(model, sealed):
    tcfg, tp = model[1], model[3]
    d, manifest = sealed[:2]
    assert manifest["format"] == tart.FORMAT
    assert manifest["fingerprint"] == tart.fingerprint(tcfg)
    assert tart.validate(d, tcfg)["fingerprint"] == manifest["fingerprint"]
    loaded, _ = tart.load(d, tcfg, run_canaries=True, device="cpu")
    flat0, flat1 = _flat(tp), _flat(loaded)
    assert set(flat0) == set(flat1)
    for k in flat0:
        assert flat0[k].dtype == flat1[k].dtype
        np.testing.assert_array_equal(flat0[k], flat1[k])
    assert tart._flatten_params(tp)[1] == tart._flatten_params(loaded)[1]


def test_canaries_are_deterministic(model, sealed):
    tcfg, tp = model[1], model[3]
    manifest = sealed[1]
    gold = tart.golden_logits(sealed[0], manifest)
    assert manifest["canaries"]
    for i, c in enumerate(manifest["canaries"]):
        toks, logits = tart.canary_run(tcfg, tp, c["prompt"],
                                       len(c["tokens"]))
        assert toks.tolist() == c["tokens"]
        np.testing.assert_array_equal(logits, gold[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(ARTIFACT_FAULTS))
def test_corruption_sweep_every_class_typed(model, request, tmp_path, kind,
                                            dtype):
    """Each injector corrupts a fresh copy of the port-sealed artifact;
    the port's load raises exactly the promised error, and it is named as
    the error the reference raises on its injector's corruption of the
    reference-sealed one. A *_signed kind gets past the byte layer."""
    jcfg, tcfg = model[:2]
    td, _, jd, _ = request.getfixturevalue(
        "sealed" if dtype == "float32" else "sealed_bf16")
    tcp, jcp = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(td, tcp)
    shutil.copytree(jd, jcp)
    plan = FaultPlan()
    expected = plan.on_artifact(tcp, kind)
    assert plan.fired == [f"artifact:{kind}"]
    with pytest.raises(expected) as ei:
        tart.load(tcp, tcfg, run_canaries=True, device="cpu")
    assert isinstance(ei.value, tart.ArtifactError)
    jexpected = jfaults.FaultPlan().on_artifact(jcp, kind)
    with pytest.raises(jexpected) as ej:
        jart.load(jcp, jcfg, run_canaries=True)
    assert type(ei.value).__name__ == type(ej.value).__name__ \
        == expected.__name__
    if kind.endswith("_signed"):
        assert expected is not tart.ArtifactChecksumError


def test_bitflip_sweep_all_regions(model, sealed, tmp_path):
    tcfg = model[1]
    d, manifest = sealed[:2]
    misses = []
    for n, region in enumerate(sorted(manifest["checksums"])):
        cp = str(tmp_path / f"flip{n}")
        shutil.copytree(d, cp)
        data = dict(np.load(os.path.join(cp, "arrays.npz")))
        a = data[region]
        buf = bytearray(a.tobytes())
        buf[len(buf) // 2] ^= 0x10
        data[region] = np.frombuffer(bytes(buf), a.dtype).reshape(a.shape)
        np.savez(os.path.join(cp, "arrays.npz"), **data)
        try:
            tart.validate(cp, tcfg)
            misses.append(region)
        except tart.ArtifactError:
            pass
    assert not misses, f"undetected bit flips in: {misses}"
    cp = str(tmp_path / "manifest")
    shutil.copytree(d, cp)
    with open(os.path.join(cp, "manifest.json"), "r+") as f:
        f.seek(10)
        f.write("#")
    with pytest.raises(tart.ArtifactIOError):
        tart.validate(cp, tcfg)


def test_validate_rejects_wrong_config(model, sealed):
    with pytest.raises(tart.ArtifactConfigError):
        tart.validate(sealed[0], port_cfg(tiny_cfg(d_ff=128)))


def test_missing_artifact_is_io_error(tmp_path):
    with pytest.raises(tart.ArtifactIOError):
        tart.validate(str(tmp_path / "nope"))


def _unbalanced(model):
    tcfg, params, masks = model[1], model[4], dict(model[5])
    path = next(iter(masks))
    m = np.asarray(jax.device_get(masks[path])).copy()
    kept = np.argwhere(m[..., 0])
    m[tuple(kept[0]) + (0,)] = False
    tmasks = {k: torch.from_numpy(np.array(v)) for k, v in masks.items()}
    tmasks[path] = torch.from_numpy(m)
    return tcfg, interop.to_torch(jax.device_get(params), device="cpu"), \
        tmasks, path


def test_pack_params_unbalanced_warns_and_reports(model):
    tcfg, params, masks, path = _unbalanced(model)
    report: dict = {}
    with pytest.warns(texport.UnbalancedMaskWarning, match="unbalanced"):
        packed = texport.pack_params(tcfg, params, masks,
                                     dtype=torch.float32, pad_report=report)
    assert 0.0 < report[path] < 1.0
    assert report[path] == pytest.approx(tpacking.pad_fraction(masks[path]))
    leaf = packed
    for k in path.split("/"):
        leaf = leaf[k]
    assert not tpacking.structure_violations(leaf)
    with pytest.raises(ValueError, match="unbalanced"):
        texport.pack_params(tcfg, params, masks, dtype=torch.float32,
                            unbalanced="raise")


def test_seal_records_pad_fractions(model, tmp_path):
    tcfg, params, masks, _ = _unbalanced(model)
    report: dict = {}
    with pytest.warns(texport.UnbalancedMaskWarning):
        packed = texport.pack_params(tcfg, params, masks,
                                     dtype=torch.float32, pad_report=report)
    d = str(tmp_path / "padded")
    assert tart.seal(tcfg, packed, d, pad=report)["pad"] == report
    assert tart.validate(d, tcfg)["pad"] == report


# ------------------------------------------------------- cross-package
@pytest.mark.parametrize("cfg_name", ["tiny", "llama32_1b"])
def test_fingerprints_equal(cfg_name):
    if cfg_name == "tiny":
        jcfg, tcfg = tiny_cfg(), port_cfg(tiny_cfg())
    else:
        jcfg, tcfg = jpm.LLAMA32_1B, tpm.LLAMA32_1B
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tart.fingerprint(tcfg) == jart.fingerprint(jcfg)


def test_manifests_agree_across_packages(sealed):
    _, tm, _, jm = sealed
    assert tm["fingerprint"] == jm["fingerprint"]
    assert tm["packed"] == jm["packed"] and tm["dtypes"] == jm["dtypes"]
    assert tm["canaries"] == jm["canaries"]     # prompts and tokens
    logits = {k for k in jm["checksums"] if k.endswith("/logits")}
    assert set(tm["checksums"]) == set(jm["checksums"])
    assert {k: v for k, v in tm["checksums"].items() if k not in logits} \
        == {k: v for k, v in jm["checksums"].items() if k not in logits}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_sealed_artifact_serves_in_port(model, tmp_path, dtype):
    jcfg, tcfg, _, _, params, masks = model
    jp = jexport.pack_params(jcfg, params, masks,
                             dtype=getattr(jnp, dtype))
    d = str(tmp_path / "jax")
    jart.seal(jcfg, jp, d)
    assert tart.validate(d, tcfg)["fingerprint"] == tart.fingerprint(tcfg)
    loaded, manifest = tart.load(d, tcfg, device="cpu")
    want = _flat(interop.to_torch(jax.device_get(jp), device="cpu"))
    got = _flat(loaded)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    report = tart.verify_canaries(
        tcfg, loaded, manifest, tart.golden_logits(d, manifest),
        max_logit_drift=CROSS_DRIFT)
    assert report["token_mismatches"] == 0
    assert report["logit_drift"] <= CROSS_DRIFT
    tart.load(d, tcfg, run_canaries=True, max_logit_drift=CROSS_DRIFT,
              device="cpu")


def test_port_sealed_artifact_validates_in_jax(model, sealed):
    jcfg = model[0]
    d = sealed[0]
    assert jart.validate(d, jcfg)["fingerprint"] == jart.fingerprint(jcfg)
    loaded, _ = jart.load(d, jcfg, run_canaries=True,
                          max_logit_drift=CROSS_DRIFT)
    want = _flat(model[3])
    got = {k: np.asarray(v) for k, v in
           jart._flatten_params(loaded)[0].items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _packed_pair(seed, kb=6, nb=3, nnz=3, bi=4, bo=4, lead=(2,)):
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(kb, nnz, replace=False))
                    for _ in range(int(np.prod(lead)) * nb)]).astype(
        np.int32).reshape(*lead, nb, nnz)
    blocks = rng.standard_normal((*lead, nb, nnz, bi, bo)).astype(np.float32)
    return idx, blocks, kb


def _corrupt(case, idx, blocks, kb):
    idx, blocks = idx.copy(), blocks.copy()
    if case == "oob":
        idx.reshape(-1)[0] = kb + 2
    elif case == "negative":
        idx.reshape(-1)[1] = -1
    elif case == "dup_data":
        idx[..., 0, 1] = idx[..., 0, 0]
    elif case == "dup_zero":
        idx[..., 0, 1] = idx[..., 0, 0]
        blocks[..., 0, 1, :, :] = 0.0
    elif case == "int64":
        idx = idx.astype(np.int64)
    elif case == "shape":
        blocks = blocks[..., :2, :, :]
    return idx, blocks


@pytest.mark.parametrize("case", ["sound", "oob", "negative", "dup_data",
                                  "dup_zero", "int64", "shape", "dims",
                                  "dense"])
def test_structure_violations_match_reference(case):
    idx, blocks, kb = _packed_pair(0)
    idx, blocks = _corrupt(case, idx, blocks, kb)
    dims = (8, 4) if case == "dims" else (4, 4)
    dense = (2, kb * 4, 13) if case == "dense" else (2, kb * 4, 12)
    jp = jpacking.PackedBCSC(blocks=blocks, idx=idx, kb=kb)
    tp = tpacking.PackedBCSC(blocks=torch.from_numpy(blocks),
                             idx=torch.from_numpy(idx), kb=kb)
    want = jpacking.structure_violations(jp, *dims, dense)
    assert tpacking.structure_violations(tp, *dims, dense) == want
    assert bool(want) == (case not in ("sound", "dup_zero"))


def test_abstract_params_shapes_match_reference():
    jcfg = tiny_cfg()
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  jreg.abstract_params(jcfg))
    got = treg.abstract_params(port_cfg(jcfg))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.shape
    assert shapes(got) == want
