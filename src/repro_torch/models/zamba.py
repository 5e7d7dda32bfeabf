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

Under ``dist`` (``distributed/context.py``) a Mamba2 layer is
head-parallel. A rank holds its heads' z, x and dt columns of
``in_proj`` and x channels of the conv, and the whole B and C columns
and channels (one group, read by every head): the cut by meaning of
``sharding.Cut`` (``ParamSpec.cut`` below), so its block is laid out
``[z_r | x_r | B C | dt_r]`` and the one-device code runs on the local
sizes. The B and C weights pass ``copy_to_model`` (their gradient, from
the rank's heads only, is summed over the model axis); ``a_log``,
``dt_bias``, ``d_skip``, ``norm_scale`` and the ``out_proj`` rows go by
heads, and the row-parallel ``out_proj`` product is summed. The gated
RMSNorm spans all of ``d_inner``, so its mean square is the model-axis
sum of the ranks' square sums over ``d_inner``, summed both ways.
The shared block is the transformer's tensor-parallel block (its
attention heads and split GLU). The decode cache holds the rank's heads'
SSM state, its x channels and the whole B/C channels of the conv tail,
and the rank's kv heads. Under ``sp`` each mixer gathers its normed
input along S (the conv and the scan see the whole sequence) and
reduce-scatters its output, as the shared block does.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.context import check_serving, check_training
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import norm, rmsnorm
from repro_torch.models.linear_scan import chunked_ssd, ssd_recurrent_step
from repro_torch.models.params import ParamSpec

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
    # the head-parallel cut: z, x, dt and the x channels by heads, B C
    # whole (``sharding.Cut``)
    conv_cut = ((d_inner, True), (2 * state, False))
    proj_cut = ((d_inner, True),) + conv_cut + ((nheads, True),)
    return {
        "ln_scale": ParamSpec((d,), ("embed",), init="zeros"),
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_proj"),
                             cut=proj_cut),
        "conv_w": ParamSpec((cfg.conv_kernel, conv_dim),
                            (None, "ssm_conv"), init="normal", scale=1.0,
                            cut=conv_cut),
        "conv_b": ParamSpec((conv_dim,), ("ssm_conv",), init="zeros",
                            cut=conv_cut),
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


def zero_padded_heads(cfg, params, dist=None) -> None:
    """The shared block's padded query heads (none in zamba2's configs;
    ``params`` this rank's shard under ``dist``)."""
    attn_mod.zero_padded_heads(cfg, params["shared"]["attn"], dist)


def sparse_paths(cfg) -> list[str]:
    return ["shared/mlp/w_gate", "shared/mlp/w_up", "shared/mlp/w_down"]


def dense_layer_flags(cfg):
    return None   # the one shared MLP is sparsified as a whole


def _app_layers(cfg) -> list[int]:
    return [i for i in range(cfg.num_layers) if i % cfg.attn_every == 0]


def n_shared_applications(cfg) -> int:
    return len(_app_layers(cfg))


def _split_proj(cfg, zxbcdt, tp: int = 1):
    """(z, x B C, dt) of the projection; ``tp`` > 1 a rank's block of the
    head-parallel cut, ``[z_r | x_r | B C | dt_r]``."""
    d_inner, nheads, headdim, state = _dims(cfg)
    di, nh = d_inner // tp, nheads // tp
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * state]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _whole_bc(w, lo: int, n: int, dist):
    """``w`` with its last dim's B C segment [lo, lo + n) (whole on every
    rank) behind ``copy_to_model``, whose backward sums that segment's
    gradient over the model axis (an identity outside autograd)."""
    if not (w.requires_grad and torch.is_grad_enabled()):
        return w
    return torch.cat([w[..., :lo], dist.copy_to_model(w[..., lo:lo + n]),
                      w[..., lo + n:]], dim=-1)


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
                decode=False, dist=None, seq=False):
    """x (B,S,D) -> (y, (new_ssm_state, new_conv_state)). Under ``dist``
    on the rank's heads (``p`` its block of the cut), ``y`` summed over
    the model axis; with ``seq`` ``x`` and ``y`` are this rank's S
    shard."""
    if DRYRUN_BASELINE:
        raise NotImplementedError("the DRYRUN_BASELINE scan variant is not "
                                  "ported")
    d_inner, nheads, headdim, state = _dims(cfg)
    split = dist is not None and dist.shards(nheads)
    tp = dist.tp if split else 1
    di, nh = d_inner // tp, nheads // tp
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    if dist is not None:
        x = dist.to_parallel(x, split, seq)
        if split:
            w_in = _whole_bc(w_in, 2 * di, 2 * state, dist)
            conv_w = _whole_bc(conv_w, di, 2 * state, dist)
            conv_b = _whole_bc(conv_b, di, 2 * state, dist)
    b, s, _ = x.shape
    zxbcdt = x @ w_in.to(x.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt, tp)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    xs = xbc[..., :di].reshape(b, s, nh, headdim)
    bmat = xbc[..., di:di + state]                       # (B,S,state)
    cmat = xbc[..., di + state:]                         # (B,S,state)
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
    y = y.reshape(b, s, di)
    # gated RMSNorm (mamba2), over all of d_inner
    g = y * F.silu(z)
    y = (rmsnorm(g, p["norm_scale"]) if not split
         else _gated_norm_tp(g, p["norm_scale"], d_inner, dist))
    y = y @ p["out_proj"].to(x.dtype)
    if dist is not None:
        y = dist.from_parallel(y, split, seq)
    return y, (new_ssm, new_conv)


def _gated_norm_tp(g, scale, d_inner: int, dist, eps: float = 1e-6):
    """``layers.rmsnorm`` over the whole ``d_inner`` of which ``g`` holds
    this rank's channels: the mean square is the model-axis sum of the
    ranks' square sums over ``d_inner``; its backward sums over the
    model axis too, since every rank's channels reach the whole sum."""
    gf = g.float()
    var = dist.copy_to_model(dist.reduce_from_model(
        torch.sum(gf * gf, dim=-1, keepdim=True))) / d_inner
    y = gf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(g.dtype)


def _shared_block(cfg, p, x, positions, masks, cache=None, pos=None,
                  dist=None, seq=False):
    """The weight-shared attention + MLP block. With ``cache`` (decode),
    (ck, cv) of THIS application, written in place. Returns (x,
    new_cache). Under ``dist`` the transformer's tensor-parallel block
    (the rank's heads, the split GLU; with ``seq`` on the S shard)."""
    from repro_torch.models import transformer
    if cache is None:
        return transformer._block(cfg, p, x, positions, masks, 0, dist,
                                  seq)[0], None
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    a, nk, nv = attn_mod.decode_attention(
        cfg, attn_mod.shard_local(cfg, p["attn"], dist), h, cache[0],
        cache[1], pos)
    x = x + transformer._heads_out(cfg, a, dist)
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    m = transformer.mlp_forward(cfg, p["mlp"], h, masks, dist=dist)[0]
    return x + m, (nk, nv)


def _shared_masks(masks):
    if not masks:
        return None
    prefix = "shared/mlp/"
    out = {k[len(prefix):]: v for k, v in masks.items()
           if k.startswith(prefix)}
    return out or None


def _mamba_layer(cfg, p_l, x, dist=None, seq=False):
    h = norm(cfg.norm_kind, x, p_l["ln_scale"], None)
    return x + mamba_mixer(cfg, p_l, h, dist=dist, seq=seq)[0]


def forward(cfg, params, tokens, *, masks=None, dist=None, **_):
    """Training forward: tokens (B,S) -> (logits (B,S,V) f32, 0.0), the
    rank's vocab shard under ``dist`` (sequence-parallel where
    ``seq_split`` allows it). With ``cfg.remat`` each Mamba layer and
    each application of the shared block is recomputed in the
    backward."""
    check_training(cfg, dist)
    from repro_torch.models.transformer import (_unbind, embed_inputs,
                                                logits_from_hidden)
    b, s = tokens.shape
    seq = dist is not None and dist.seq_split((b, s, cfg.d_model))
    x = embed_inputs(cfg, params, tokens, dist=dist, seq=seq)
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
        return _shared_block(cfg, params["shared"], x, positions, smasks,
                             dist=dist, seq=seq)[0]

    for i, p_l in enumerate(_unbind(params["layers"])):
        if i % cfg.attn_every == 0:
            x = run(shared, x)
        x = run(_mamba_layer, cfg, p_l, x, dist, seq)
    return logits_from_hidden(cfg, params, x, dist, seq), 0.0


# ------------------------------------------------------------------ decode
def _local_dims(cfg, dist):
    """(x channels, heads, kv heads) a rank holds under ``dist``."""
    d_inner, nheads, _, _ = _dims(cfg)
    tp = dist.tp if dist is not None and dist.shards(nheads) else 1
    return d_inner // tp, nheads // tp, attn_mod.local_heads(cfg, dist)[3]


def _cache_shapes(cfg, batch: int, max_len: int, dist):
    di, nh, kv = _local_dims(cfg, dist)
    _, _, headdim, state = _dims(cfg)
    n = cfg.num_layers
    kv_shape = (n_shared_applications(cfg), batch, max_len, kv, cfg.head_dim)
    return {"ssm": (n, batch, nh, state, headdim),
            "conv": (n, batch, cfg.conv_kernel - 1, di + 2 * state),
            "k": kv_shape, "v": kv_shape}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", dist=None):
    """Per Mamba layer the f32 SSM state and the conv's last K-1 inputs,
    per application of the shared block a contiguous KV cache (the
    rank's heads, x channels and kv heads under ``dist``)."""
    return {k: torch.zeros(shape, dtype=torch.float32 if k == "ssm"
                           else dtype, device=device)
            for k, shape in _cache_shapes(cfg, batch, max_len, dist).items()}


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   dist=None):
    """Shapes and dtypes of ``init_cache``'s state (no allocation)."""
    from repro_torch.models.params import AbstractParam
    return {k: AbstractParam(shape, torch.float32 if k == "ssm" else dtype)
            for k, shape in _cache_shapes(cfg, batch, max_len, dist).items()}


def decode_step(cfg, params, cache, tokens, pos, *, dist=None, **_):
    """One decode step: each application of the shared block (over its own
    KV cache, the new token at slot ``pos``) followed by its span of Mamba
    layers, the last span shorter when ``attn_every`` does not divide the
    depth. Returns (logits (B,1,V) f32, the rank's vocab shard under
    ``dist``, cache), updated in place."""
    check_serving(cfg, dist)
    from repro_torch.models.transformer import (_layer_view, embed_inputs,
                                                logits_from_hidden)
    x = embed_inputs(cfg, params, tokens, dist=dist)
    apps = _app_layers(cfg)
    ssm = cache["ssm"]
    if cache["conv"].dtype != x.dtype:
        cache["conv"] = cache["conv"].to(x.dtype)
    conv = cache["conv"]
    for j, (lo, hi) in enumerate(zip(apps, apps[1:] + [cfg.num_layers])):
        x, _ = _shared_block(cfg, params["shared"], x, None, None,
                             cache=(cache["k"][j], cache["v"][j]), pos=pos,
                             dist=dist)
        for i in range(lo, hi):
            p_l = _layer_view(params["layers"], i)
            h = norm(cfg.norm_kind, x, p_l["ln_scale"], None)
            y, (nst, ncv) = mamba_mixer(cfg, p_l, h, ssm_state=ssm[i],
                                        conv_state=conv[i], decode=True,
                                        dist=dist)
            x = x + y
            ssm[i] = nst
            conv[i] = ncv
    return logits_from_hidden(cfg, params, x, dist), cache
