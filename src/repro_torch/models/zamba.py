"""zamba2, the ``hybrid`` family (port of ``repro/models/zamba.py``): a
stack of Mamba2 (SSD) layers with ONE weight-shared transformer block
(attention + GLU MLP) applied before layer i whenever ``i % attn_every ==
0`` (arXiv:2411.15242; the per-application LoRA is omitted, as in the
reference).

Mamba2 layer: in_proj -> [z | x B C | dt]; a causal depthwise conv with
SiLU on (x, B, C); a scalar decay per head a_t = exp(-softplus(dt +
bias)·exp(A_log)); the grouped SSD of ``linear_scan.chunked_ssd`` (B and
C shared across heads); ``y + x·D``; the gated RMSNorm; out_proj. BLaST
applies to the shared block's MLP only, a 2-D (not layer-stacked) GLU:
packed, it runs through the fused-GLU kernel and ``bspmm``.

Only the grouped-SSD branch, the served one, is ported: the reference's
``DRYRUN_BASELINE`` variant (a broadcast per-channel scan, for its
dry-run cost model) is not.

The decode cache holds per Mamba layer the f32 SSM state and the conv's
last K-1 inputs, and per application of the shared block a
contiguous KV cache; ``decode_step`` interleaves the applications with
the Mamba spans and updates the cache in place. As in the reference,
the conv tail a step writes back is in the compute dtype (the cache dtype
only holds the zeros it starts from), so with an f32 compute dtype and a
bf16 cache the first step replaces ``cache["conv"]`` by an f32 copy.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import sparse_mlp as sm
from repro_torch.distributed.context import refuse_dist
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import norm, rmsnorm
from repro_torch.models.linear_scan import chunked_ssd, ssd_recurrent_step
from repro_torch.models.params import DTYPES, ParamSpec

# the reference's switch to its pre-optimisation scan, read the same way
DRYRUN_BASELINE = bool(os.environ.get("DRYRUN_BASELINE"))


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads
    headdim = d_inner // nheads
    return d_inner, nheads, headdim, cfg.ssm_state


def mamba_param_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nheads, headdim, state = _dims(cfg)
    conv_dim = d_inner + 2 * state
    proj_out = 2 * d_inner + 2 * state + nheads
    return {
        "ln_scale": ParamSpec((d,), ("embed",), init="zeros"),
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_proj")),
        "conv_w": ParamSpec((cfg.conv_kernel, conv_dim),
                            (None, "ssm_conv"), init="normal", scale=1.0),
        "conv_b": ParamSpec((conv_dim,), ("ssm_conv",), init="zeros"),
        "a_log": ParamSpec((nheads,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec((nheads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((nheads,), ("ssm_heads",), init="ones"),
        "norm_scale": ParamSpec((d_inner,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed"),
                              scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def shared_block_specs(cfg) -> dict:
    from repro_torch.models.transformer import _norm_specs, mlp_param_specs
    specs = {}
    specs.update(_norm_specs(cfg, "ln_attn"))
    specs["attn"] = attn_mod.attn_param_specs(cfg)
    specs.update(_norm_specs(cfg, "ln_mlp"))
    specs["mlp"] = mlp_param_specs(cfg)
    return specs


def param_specs(cfg) -> dict:
    from repro_torch.models.transformer import _norm_specs, _stack_specs
    specs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), init="embed"),
        "layers": _stack_specs(mamba_param_specs(cfg), cfg.num_layers),
        "shared": shared_block_specs(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), init="embed"),
    }
    specs.update(_norm_specs(cfg, "ln_f"))
    return specs


def zero_padded_heads(cfg, params) -> None:
    """The shared block's padded query heads (none in zamba2's configs)."""
    attn_mod.zero_padded_heads(cfg, params["shared"]["attn"])


def sparse_paths(cfg) -> list[str]:
    return ["shared/mlp/w_gate", "shared/mlp/w_up", "shared/mlp/w_down"]


def dense_layer_flags(cfg):
    return None   # the one shared MLP is sparsified as a whole


def _app_layers(cfg) -> list[int]:
    return [i for i in range(cfg.num_layers) if i % cfg.attn_every == 0]


def n_shared_applications(cfg) -> int:
    return len(_app_layers(cfg))


def _split_proj(cfg, zxbcdt):
    d_inner, nheads, headdim, state = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * state]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv with SiLU. x (B,S,C); w (K,C). Returns (y,
    tail): tail is the last K-1 inputs (the decode state)."""
    k = w.shape[0]
    pad = (torch.zeros_like(x[:, :k - 1]) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    y = F.silu(y + b.to(x.dtype))
    return y, xp[:, -(k - 1):]


def mamba_mixer(cfg, p, x, *, ssm_state=None, conv_state=None,
                decode=False):
    """x (B,S,D) -> (y, (new_ssm_state, new_conv_state))."""
    if DRYRUN_BASELINE:
        raise NotImplementedError("the DRYRUN_BASELINE scan variant is not "
                                  "ported")
    d_inner, nheads, headdim, state = _dims(cfg)
    b, s, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :d_inner].reshape(b, s, nheads, headdim)
    bmat = xbc[..., d_inner:d_inner + state]             # (B,S,state)
    cmat = xbc[..., d_inner + state:]                    # (B,S,state)
    dt_s = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                   # (H,)
    log_a = dt_s * a                                     # (B,S,H)
    v = xs * dt_s[..., None].to(xs.dtype)
    if decode:
        y, new_ssm = ssd_recurrent_step(cmat[:, 0], bmat[:, 0], v[:, 0],
                                        log_a[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, new_ssm = chunked_ssd(cmat, bmat, v, log_a, chunk=cfg.chunk_size,
                                 initial_state=ssm_state)
    y = y + xs * p["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(b, s, d_inner)
    # gated RMSNorm (mamba2)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"].to(x.dtype), (new_ssm, new_conv)


def _shared_block(cfg, p, x, positions, masks, cache=None, pos=None):
    """The weight-shared attention + MLP block. With ``cache`` (decode),
    (ck, cv) of THIS application, written in place. Returns (x,
    new_cache)."""
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    if cache is None:
        a, _ = attn_mod.multihead_attention(cfg, p["attn"], h, positions,
                                            causal=True)
        new_cache = None
    else:
        a, nk, nv = attn_mod.decode_attention(cfg, p["attn"], h, cache[0],
                                              cache[1], pos)
        new_cache = (nk, nv)
    x = x + a
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    m = sm.glu_mlp(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                   p["mlp"]["w_down"], act=cfg.mlp_act, masks=masks,
                   spec=cfg.blast)
    return x + m, new_cache


def _shared_masks(masks):
    if not masks:
        return None
    prefix = "shared/mlp/"
    out = {k[len(prefix):]: v for k, v in masks.items()
           if k.startswith(prefix)}
    return out or None


def _embed(cfg, params, tokens):
    return params["embed"][tokens.long()].to(DTYPES[cfg.compute_dtype])


def _mamba_layer(cfg, p_l, x):
    h = norm(cfg.norm_kind, x, p_l["ln_scale"], None)
    return x + mamba_mixer(cfg, p_l, h)[0]


def forward(cfg, params, tokens, *, masks=None, dist=None, **_):
    """Training forward: tokens (B,S) -> (logits (B,S,V) f32, 0.0). With
    ``cfg.remat`` each Mamba layer and each application of the shared
    block is recomputed in the backward."""
    refuse_dist(dist, "zamba (hybrid)")
    from repro_torch.models.transformer import _unbind, logits_from_hidden
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    smasks = _shared_masks(masks)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def shared(x):
        return _shared_block(cfg, params["shared"], x, positions, smasks)[0]

    for i, p_l in enumerate(_unbind(params["layers"])):
        if i % cfg.attn_every == 0:
            x = run(shared, x)
        x = run(_mamba_layer, cfg, p_l, x)
    return logits_from_hidden(cfg, params, x), 0.0


# ------------------------------------------------------------------ decode
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    d_inner, nheads, headdim, state = _dims(cfg)
    napp = n_shared_applications(cfg)
    _, kv = attn_mod.eff_heads(cfg)
    n = cfg.num_layers
    kv_shape = (napp, batch, max_len, kv, cfg.head_dim)
    return {
        "ssm": torch.zeros((n, batch, nheads, state, headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n, batch, cfg.conv_kernel - 1,
                             d_inner + 2 * state), dtype=dtype,
                            device=device),
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
    }


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """Shapes and dtypes of ``init_cache``'s state (no allocation)."""
    from repro_torch.models.params import AbstractParam
    d_inner, nheads, headdim, state = _dims(cfg)
    _, kv = attn_mod.eff_heads(cfg)
    n = cfg.num_layers
    kv_shape = (n_shared_applications(cfg), batch, max_len, kv, cfg.head_dim)
    return {"ssm": AbstractParam((n, batch, nheads, state, headdim),
                                 torch.float32),
            "conv": AbstractParam((n, batch, cfg.conv_kernel - 1,
                                   d_inner + 2 * state), dtype),
            "k": AbstractParam(kv_shape, dtype),
            "v": AbstractParam(kv_shape, dtype)}


def decode_step(cfg, params, cache, tokens, pos, *, dist=None, **_):
    """One decode step: each application of the shared block (over its own
    KV cache, the new token at slot ``pos``) followed by its span of Mamba
    layers, the last span shorter when ``attn_every`` does not divide the
    depth. Returns (logits (B,1,V) f32, cache), updated in place."""
    refuse_dist(dist, "zamba (hybrid)")
    from repro_torch.models.transformer import _layer_view, logits_from_hidden
    x = _embed(cfg, params, tokens)
    apps = _app_layers(cfg)
    ssm = cache["ssm"]
    if cache["conv"].dtype != x.dtype:
        cache["conv"] = cache["conv"].to(x.dtype)
    conv = cache["conv"]
    for j, (lo, hi) in enumerate(zip(apps, apps[1:] + [cfg.num_layers])):
        x, _ = _shared_block(cfg, params["shared"], x, None, None,
                             cache=(cache["k"][j], cache["v"][j]), pos=pos)
        for i in range(lo, hi):
            p_l = _layer_view(params["layers"], i)
            h = norm(cfg.norm_kind, x, p_l["ln_scale"], None)
            y, (nst, ncv) = mamba_mixer(cfg, p_l, h, ssm_state=ssm[i],
                                        conv_state=conv[i], decode=True)
            x = x + y
            ssm[i] = nst
            conv[i] = ncv
    return logits_from_hidden(cfg, params, x), cache
