"""Sealed serving artifacts (port of ``repro/serving/artifact.py``): the
validated boundary between the trainer and the server.

BLaST's prune-and-grow schedule emits ever-sparser packed snapshots, and
they must reach serving intact. A ``PackedBCSC`` is where silent
corruption is cheapest to catch statically (an out-of-range ``idx``
entry gathers garbage blocks and serves wrong tokens with no crash), so
an artifact is sealed with three nested layers of evidence, verified in
order on load:

  1. **bytes**: a per-array crc32 manifest (``checkpointing.crc32_array``)
     and an exact array-set match: bit rot, torn writes and dropped
     leaves fail here;
  2. **structure**: the config fingerprint, and for every packed leaf
     the static invariants (``core/packing.structure_violations``), the
     finiteness of every float leaf and the ``joint`` gate/up promise
     (identical idx tables). A corruption whose checksums were
     recomputed still fails here;
  3. **behaviour**: golden canary generations. At seal time a few
     prompts run greedy decode through ``canary_run`` and the tokens and
     final-step logits are stored; ``verify_canaries`` re-runs the same
     function on the loaded weights. On the same device an intact
     artifact reproduces the goldens bitwise, so the default gates are
     exact (0 token mismatches, 0.0 logit drift); a structure-preserving
     corruption (a scaled block, re-signed) fails only here.

Every failure raises a typed ``ArtifactError`` before a token is served.

The layout is the reference's, so either package validates and serves
what the other sealed (atomic: written to ``<dir>.tmp``, renamed in)::

    <dir>/arrays.npz     params (packed leaves split into <path>/blocks
                         and <path>/idx; bfloat16 stored as uint16 bit
                         patterns) and canary goldens
                         (__canary__/<i>/{tokens,logits})
    <dir>/manifest.json  format, config fingerprint, checksums, packed
                         leaf metadata {kb, joint}, dtypes, pad
                         fractions, canary prompts and a JSON copy of the
                         golden tokens (cross-checked against the npz)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.checkpointing.checkpoint import (crc32_array, decode_leaf,
                                                  encode_leaf, flatten_tree,
                                                  to_host)
from repro_torch.core import packing, sparse_mlp as sm
from repro_torch.core.packing import PackedBCSC
from repro_torch.models import registry
from repro_torch.serving.faults import ServingFault

FORMAT = "blast-artifact-v1"


# ------------------------------------------------------------- errors
class ArtifactError(ServingFault):
    """Base: a sealed artifact failed verification (or could not be
    read). Raised before any engine step consumes the weights."""


class ArtifactIOError(ArtifactError):
    """Missing, unreadable or unparseable artifact files."""


class ArtifactChecksumError(ArtifactError):
    """Byte layer: crc32 mismatch, array-set drift, or the manifest's
    canary-token copy diverging from the npz copy."""


class ArtifactConfigError(ArtifactError):
    """The artifact was sealed for a different model config."""


class ArtifactStructureError(ArtifactError):
    """A packed leaf violates a static structural invariant (idx range,
    block dims, dense extent, duplicate rule, joint promise)."""


class ArtifactNonFiniteError(ArtifactError):
    """A float leaf contains NaN/Inf."""


class ArtifactCanaryError(ArtifactError):
    """The loaded weights no longer reproduce the golden canary
    generations within the gates (token mismatches / logit drift)."""


# -------------------------------------------------------- fingerprint
def fingerprint(cfg) -> str:
    """Stable digest of the model config an artifact was sealed for (the
    port's ``ModelConfig`` matches the reference's field for field, so
    the digests agree)."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------- flatten helpers
def _flatten_params(params):
    """Params tree -> (flat host tensors, packed-leaf metadata): each
    packed leaf splits into ``<path>/blocks`` and ``<path>/idx``. Every
    device copy is queued first and one device sync covers them all."""
    arrays, packed = {}, {}
    for k, v in flatten_tree(params).items():
        if isinstance(v, PackedBCSC):
            arrays[f"{k}/blocks"] = to_host(v.blocks)
            arrays[f"{k}/idx"] = to_host(v.idx)
            packed[k] = {"kb": int(v.kb), "joint": bool(v.joint)}
        else:
            arrays[k] = to_host(v)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return arrays, packed


def _unflatten_params(arrays: dict, packed: dict, device):
    """Flat host tensors and packed metadata -> the nested params dict on
    ``device``."""
    def put(t):
        return t.to(device)

    leaves: dict = {}
    for path, meta in packed.items():
        leaves[path] = PackedBCSC(
            blocks=put(arrays[f"{path}/blocks"]),
            idx=put(arrays[f"{path}/idx"]),
            kb=int(meta["kb"]), joint=bool(meta["joint"]))
    for k, v in arrays.items():
        if k.startswith("__canary__/"):
            continue
        base, leaf = k.rsplit("/", 1) if "/" in k else ("", k)
        if leaf in ("blocks", "idx") and base in packed:
            continue
        leaves[k] = put(v)
    tree: dict = {}
    for path, v in leaves.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _checked(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A stored array in a form the structure and finiteness checks read
    as they would its values: bfloat16 as its bits without the sign (0
    exactly for +-0.0, >= 0x7F80 exactly for Inf and NaN), so the checks
    need no widened float32 copy."""
    if dtype == "bfloat16":
        return np.bitwise_and(arr.view(np.uint16), np.uint16(0x7FFF))
    return arr if str(arr.dtype) == dtype else arr.view(np.dtype(dtype))


def _device_of(params):
    for v in flatten_tree(params).values():
        t = v.blocks if isinstance(v, PackedBCSC) else v
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("params hold no tensor")


# -------------------------------------------------------------- canary
def default_canary_prompts(cfg, n_prompts: int = 2,
                           prompt_len: int = 8) -> list[list[int]]:
    """Deterministic pseudo-prompts spread over the vocab (no RNG: the
    same cfg always yields the same canary set)."""
    v = cfg.vocab_size
    return [[(7 * (i + 1) * (j + 3) + 11 * i + 5) % v
             for j in range(prompt_len)] for i in range(n_prompts)]


@torch.inference_mode()
def canary_run(cfg, params, prompt, n_tokens: int):
    """The canonical canary generation: greedy token-by-token decode of one
    prompt through the oracle serving path (``serve_loop``'s prefill and
    ``make_decode_step`` over the contiguous cache; on the GPU through
    ``bspmm`` and the fused GLU kernels), on the params' device. The same
    function on intact weights on one device reproduces its output
    bitwise, so the default acceptance gates are exact.

    Returns (tokens (n_tokens,) int32, last-step logits (V,) f32)."""
    from repro_torch.serving.serve_loop import prefill_with_decode
    from repro_torch.serving.step import make_decode_step
    dev = _device_of(params)
    prompts = np.asarray(prompt, np.int32)[None, :]
    plen = prompts.shape[1]
    last, cache = prefill_with_decode(cfg, params, prompts, plen + n_tokens,
                                      device=dev)
    decode = make_decode_step(cfg)
    nxt = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    toks = [nxt]
    for i in range(n_tokens - 1):
        nxt, cache, last, _ = decode(params, cache, nxt, plen + i)
        toks.append(nxt)
    return (torch.cat(toks, dim=1)[0].cpu().numpy().astype(np.int32),
            last[0].float().cpu().numpy())


def verify_canaries(cfg, params, manifest: dict, golden_logits: dict, *,
                    max_token_mismatches: int = 0,
                    max_logit_drift: float = 0.0) -> dict:
    """Re-run every canary on ``params`` and gate against the goldens.

    ``golden_logits`` maps canary index -> stored (V,) f32 final-step
    logits. Returns a report dict; raises ``ArtifactCanaryError`` when
    any canary exceeds the gates. The defaults are exact gates."""
    report = {"canaries": [], "token_mismatches": 0, "logit_drift": 0.0}
    for i, c in enumerate(manifest["canaries"]):
        toks, logits = canary_run(cfg, params, c["prompt"], len(c["tokens"]))
        mism = int(np.sum(toks != np.asarray(c["tokens"], np.int32)))
        drift = float(np.max(np.abs(logits - golden_logits[i]))) \
            if i in golden_logits else 0.0
        report["canaries"].append(
            {"i": i, "token_mismatches": mism, "logit_drift": drift,
             "tokens": toks.tolist()})
        report["token_mismatches"] += mism
        report["logit_drift"] = max(report["logit_drift"], drift)
    if (report["token_mismatches"] > max_token_mismatches
            or report["logit_drift"] > max_logit_drift):
        raise ArtifactCanaryError(
            f"canary gate failed: {report['token_mismatches']} token "
            f"mismatch(es) (gate {max_token_mismatches}), max logit "
            f"drift {report['logit_drift']:.3e} (gate "
            f"{max_logit_drift:.3e}) — weights do not reproduce the "
            "sealed goldens")
    return report


# ---------------------------------------------------------------- seal
def seal(cfg, params, out_dir: str, *, canary_prompts=None,
         canary_tokens: int = 8, pad: dict | None = None) -> dict:
    """Seal packed serving params (``export.pack_params`` output) into a
    validated artifact directory: the config fingerprint, per-array
    crc32s, and the golden canary generations on the exact weights being
    sealed, run on the params' device. ``pad`` is export's per-path
    pad-fraction report. Returns the manifest. Atomic: assembled in
    ``<dir>.tmp`` and renamed into place."""
    arrays, packed = _flatten_params(params)
    if canary_prompts is None:
        canary_prompts = default_canary_prompts(cfg)
    canaries = []
    for i, prompt in enumerate(canary_prompts):
        toks, logits = canary_run(cfg, params, prompt, canary_tokens)
        arrays[f"__canary__/{i}/tokens"] = toks
        arrays[f"__canary__/{i}/logits"] = logits
        canaries.append({"prompt": [int(t) for t in prompt],
                         "tokens": toks.tolist()})
    stored, dtypes = {}, {}
    for k, v in arrays.items():
        stored[k], dtypes[k] = encode_leaf(v)
    manifest = {
        "format": FORMAT,
        "fingerprint": fingerprint(cfg),
        "checksums": {k: crc32_array(v) for k, v in stored.items()},
        "packed": packed,
        "dtypes": dtypes,
        "pad": {k: float(v) for k, v in (pad or {}).items()},
        "canaries": canaries,
    }
    tmp, final = out_dir + ".tmp", out_dir
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **stored)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return manifest


# ------------------------------------------------------------ validate
def _read_manifest(d: str) -> dict:
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise ArtifactIOError(f"no manifest.json in {d}") from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ArtifactIOError(f"manifest.json unreadable: {e}") from None
    if manifest.get("format") != FORMAT:
        raise ArtifactIOError(
            f"unknown artifact format {manifest.get('format')!r} "
            f"(expected {FORMAT!r})")
    return manifest


def _read(d: str):
    manifest = _read_manifest(d)
    try:
        with np.load(os.path.join(d, "arrays.npz")) as z:
            stored = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise ArtifactIOError(f"no arrays.npz in {d}") from None
    except Exception as e:
        raise ArtifactIOError(f"arrays.npz unreadable: {e}") from None
    return manifest, stored


def _validate(manifest: dict, stored: dict, cfg) -> None:
    # layer 1: bytes, the exact array set, then per-array crc32
    cks = manifest.get("checksums", {})
    missing = sorted(set(cks) - set(stored))
    extra = sorted(set(stored) - set(cks))
    if missing or extra:
        raise ArtifactChecksumError(
            f"array set drift: missing {missing[:4]}, "
            f"unmanifested {extra[:4]}")
    got = {k: crc32_array(v) for k, v in stored.items()}
    for k in sorted(stored):
        if got[k] != cks[k]:
            raise ArtifactChecksumError(
                f"crc32 mismatch on {k!r}: artifact bytes corrupt")

    # canary cross-check: the manifest's JSON token copy vs the npz copy
    for i, c in enumerate(manifest.get("canaries", [])):
        npz_toks = stored.get(f"__canary__/{i}/tokens")
        if npz_toks is None or not np.array_equal(
                np.asarray(c["tokens"], np.int32), npz_toks):
            raise ArtifactChecksumError(
                f"canary {i} golden tokens diverge between manifest "
                "and arrays (tampered goldens)")

    # layer 2a: config fingerprint
    if cfg is not None and manifest.get("fingerprint") != fingerprint(cfg):
        raise ArtifactConfigError(
            "artifact was sealed for a different config "
            f"(fingerprint {manifest.get('fingerprint', '')[:12]}… != "
            f"{fingerprint(cfg)[:12]}…)")

    dtypes = manifest["dtypes"]

    def vals(k):
        return _checked(stored[k], dtypes[k])

    # layer 2b: structural invariants of every packed leaf
    abs_tmpl = registry.abstract_params(cfg) if cfg is not None else None
    for path, meta in manifest.get("packed", {}).items():
        p = PackedBCSC(blocks=vals(f"{path}/blocks"),
                       idx=vals(f"{path}/idx"),
                       kb=int(meta["kb"]), joint=bool(meta["joint"]))
        bi = bo = dense = None
        if cfg is not None:
            bi, bo = sm.block_dims_for(cfg.blast, path)
            dense = sm.get_path(abs_tmpl, path).shape
        bad = packing.structure_violations(p, bi, bo, dense)
        if bad:
            raise ArtifactStructureError(
                f"packed leaf {path!r}: " + "; ".join(bad))
        if meta.get("joint"):
            leaf = path.split("/")[-1]
            partner = path[:-len(leaf)] + (
                leaf.replace("gate", "up") if "gate" in leaf
                else leaf.replace("up", "gate"))
            pkey = f"{partner}/idx"
            if pkey not in stored or not np.array_equal(p.idx, vals(pkey)):
                raise ArtifactStructureError(
                    f"joint promise broken: {path!r} marked joint but "
                    f"its idx table differs from {partner!r} — the "
                    "fused GLU kernel would contract the wrong blocks")

    # layer 2c: finiteness of every float leaf (canary logits included)
    for k in stored:
        v = vals(k)
        if dtypes[k] == "bfloat16":
            bad = bool((v >= 0x7F80).any())
        else:
            bad = v.dtype.kind == "f" and not bool(np.isfinite(v).all())
        if bad:
            raise ArtifactNonFiniteError(f"non-finite values in {k!r}")


def validate(d: str, cfg=None) -> dict:
    """Verify an artifact directory layer by layer (bytes, then structure
    and metadata) without building any device state. With ``cfg``, also
    the config fingerprint and the packed leaves' shapes against the
    registry. Raises a typed ``ArtifactError``; returns the manifest."""
    manifest, stored = _read(d)
    _validate(manifest, stored, cfg)
    return manifest


def load(d: str, cfg=None, *, run_canaries: bool = False,
         max_token_mismatches: int = 0, max_logit_drift: float = 0.0,
         device="cuda"):
    """Validate an artifact and place its params on ``device``. Returns
    ``(params, manifest)``. With ``run_canaries`` (needs ``cfg``), the
    golden generations are replayed on the loaded weights before
    returning."""
    manifest, stored = _read(d)
    _validate(manifest, stored, cfg)
    arrays = {k: decode_leaf(v, manifest["dtypes"][k])
              for k, v in stored.items() if not k.startswith("__canary__/")}
    params = _unflatten_params(arrays, manifest.get("packed", {}), device)
    if run_canaries:
        if cfg is None:
            raise ValueError("run_canaries needs the model config")
        goldens = {i: np.asarray(stored[f"__canary__/{i}/logits"],
                                 np.float32)
                   for i in range(len(manifest.get("canaries", [])))}
        verify_canaries(cfg, params, manifest, goldens,
                        max_token_mismatches=max_token_mismatches,
                        max_logit_drift=max_logit_drift)
    return params, manifest


def golden_logits(d: str, manifest: dict | None = None) -> dict:
    """The stored final-step canary logits, keyed by canary index (only
    those arrays are read)."""
    manifest = manifest if manifest is not None else _read_manifest(d)
    try:
        with np.load(os.path.join(d, "arrays.npz")) as z:
            return {i: np.asarray(z[f"__canary__/{i}/logits"], np.float32)
                    for i in range(len(manifest.get("canaries", [])))}
    except (OSError, KeyError, ValueError) as e:
        raise ArtifactIOError(f"arrays.npz unreadable: {e}") from None
