"""RWKV6 "Finch" (arXiv:2404.05892), the ``ssm`` family (port of
``repro/models/rwkv6.py``): an attention-free LM with data-dependent
per-channel decay.

Per layer: time-mix (the token mixer, ``linear_scan``'s chunked linear
attention in its RWKV "bonus" mode) and channel-mix (the square-ReLU
two-matrix MLP, where BLaST applies: packed, it runs through ``bspmm``
twice). Static token-shift interpolation weights (mu) and the
data-dependent decay LoRA, as in the reference.

Heads are padded to ``pad_heads_to`` (40 -> 48 at full size). The
reference initialises the padded heads as live; here ``zero_padded_heads``
zeroes their ``w_r``/``w_k``/``w_v``/``w_g`` columns and ``w_o`` rows, so
a seeded model computes with ``num_heads`` heads (parity tests share
weights, so this never enters them). The 3-D projections name their true
fan-in (``ParamSpec.fan_in``).

Layers loop in Python over per-layer views of the stacked params. The
decode cache holds, per layer, the f32 recurrent state and the last
token's time-mix and channel-mix inputs in the cache dtype; ``decode_step``
updates it in place.

Under ``dist`` (``distributed/context.py``) the time mix is
head-parallel: a rank holds its heads' ``w_r``/``w_k``/``w_v``/``w_g``
columns, ``lora_b``, ``w0``, ``u`` and ``ln_x_scale`` and its ``w_o``
rows (48 heads, 24 a rank at tp 2), computes the recurrence and the
per-head group norm of those heads, and the row-parallel ``w_o`` product
is summed over the model axis; ``mu_*`` and ``lora_a`` stay whole and
hold partial gradients (``sharding.partial_flags``). The channel mix is
``sparse_mlp.mlp2``'s tensor-parallel path, with ``w_recept`` whole and
the receptance applied after the sum. The embedding and the head are the
transformer's vocab-sharded ones. Under ``sp`` the residual stream is
the rank's S shard (``DistContext.seq_split``): the time mix gathers its
normed input along S, so the token shift and the chunked scan see the
whole sequence, and reduce-scatters its output; the channel mix shifts
on its shard, the first token taking the previous shard's last
(``_seq_shift``), and ``mlp2`` gathers along S itself. The decode cache
holds the rank's heads' state and the whole last inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import sparse_mlp as sm
from repro_torch.distributed.context import check_serving, check_training
from repro_torch.models.layers import layernorm
from repro_torch.models.linear_scan import (chunked_linear_attention,
                                            recurrent_step)
from repro_torch.models.params import ParamSpec

LORA_RANK = 64


def _heads(cfg):
    h = max(cfg.num_heads, cfg.pad_heads_to or 0)
    return h, cfg.head_dim, h * cfg.head_dim   # (H, dk, inner)


def layer_param_specs(cfg) -> dict:
    d = cfg.d_model
    h, dk, inner = _heads(cfg)
    f = cfg.d_ff
    out_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    emb = lambda: ParamSpec((d,), ("embed",), init="zeros")  # noqa: E731
    hk = ("heads", "head_dim")
    proj = lambda: ParamSpec((d, h, dk), ("embed",) + hk,  # noqa: E731
                             fan_in=d)
    return {
        "ln1_scale": ParamSpec((d,), ("embed",), init="ones"),
        "ln1_bias": emb(),
        "ln2_scale": ParamSpec((d,), ("embed",), init="ones"),
        "ln2_bias": emb(),
        "tmix": {
            "mu_r": emb(), "mu_k": emb(), "mu_v": emb(), "mu_g": emb(),
            "mu_w": emb(),
            "w_r": proj(), "w_k": proj(), "w_v": proj(), "w_g": proj(),
            "w_o": ParamSpec((h, dk, d), hk + ("embed",), scale=out_scale,
                             fan_in=inner),
            # data-dependent decay: w = w0 + tanh(x A) B   (Finch LoRA)
            "w0": ParamSpec((h, dk), hk, init="zeros"),
            "lora_a": ParamSpec((d, LORA_RANK), ("embed", None)),
            "lora_b": ParamSpec((LORA_RANK, h, dk), (None,) + hk,
                                fan_in=LORA_RANK),
            "u": ParamSpec((h, dk), hk, init="zeros"),
            "ln_x_scale": ParamSpec((h, dk), hk, init="ones"),
        },
        "mlp": {
            "mu_k": emb(), "mu_r": emb(),
            "w_in": ParamSpec((d, f), ("embed", "ff")),
            "w_out": ParamSpec((f, d), ("ff", "embed"), scale=out_scale),
            "w_recept": ParamSpec((d, d), ("embed", "embed2")),
        },
    }


def param_specs(cfg) -> dict:
    from repro_torch.models.transformer import _norm_specs, _stack_specs
    specs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), init="embed"),
        "layers": _stack_specs(layer_param_specs(cfg), cfg.num_layers),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), init="embed"),
    }
    specs.update(_norm_specs(cfg, "ln_f"))
    return specs


def zero_padded_heads(cfg, params, dist=None) -> None:
    """Zero, in place, every layer's time-mix ``w_r``/``w_k``/``w_v``/
    ``w_g`` columns and ``w_o`` rows of the heads ``pad_heads_to`` adds
    (heads >= ``num_heads``): their r, k and v are then zero, so is their
    state and output, and the padding adds nothing. Under ``dist``
    ``params`` is this rank's shard, whose local head j is global head
    ``model_rank * local + j`` (rwkv6-3b at model 2: rank 0's 24 heads
    are live, rank 1 holds 16 live and 8 padded)."""
    h, _, _ = _heads(cfg)
    if h > cfg.num_heads:
        p = params["layers"]["tmix"]
        n = p["w_r"].shape[-2]
        first = 0
        if n < h:
            if dist is None:
                raise ValueError("a shard of the heads needs dist=")
            first = dist.model_rank * n
        live = min(max(cfg.num_heads - first, 0), n)
        with torch.no_grad():
            for name in ("w_r", "w_k", "w_v", "w_g"):
                p[name][..., live:, :].zero_()
            p["w_o"][..., live:, :, :].zero_()


def sparse_paths(cfg) -> list[str]:
    return ["layers/mlp/w_in", "layers/mlp/w_out"]


def dense_layer_flags(cfg) -> torch.Tensor:
    """(layers,) bool on the CPU: the last ``dense_last`` layers stay
    dense."""
    return torch.arange(cfg.num_layers) >= (cfg.num_layers
                                            - cfg.blast.dense_last)


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or ``last`` at t = 0). x (B,S,D)."""
    pad = (torch.zeros_like(x[:, :1]) if last is None
           else last[:, None].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _seq_shift(x, dist):
    """Token shift of this rank's S shard of a sequence-parallel stream:
    the first token takes the previous shard's last (zeros on rank 0),
    one all-gather of every shard's last token (whose backward
    reduce-scatters, handing each last token the gradient of the shard
    after it)."""
    r = dist.model_rank
    prev = dist.gather_from_seq(x[:, -1:])          # (B, tp, D)
    pad = prev[:, max(r - 1, 0):max(r, 1)] * (1.0 if r else 0.0)
    return torch.cat([pad, x[:, :-1]], dim=1)


def time_mix(cfg, p, x, *, state=None, x_last=None, decode=False,
             dist=None, seq=False):
    """x (B,S,D). Returns (y, (new_state, new_x_last)). Under ``dist`` on
    the rank's heads (``p`` its shard), ``y`` summed over the model axis;
    with ``seq`` ``x`` and ``y`` are this rank's S shard."""
    dt = x.dtype
    if dist is not None:
        x = dist.to_parallel(x, True, seq)
    xs = _shift(x, x_last)

    def proj(mu, w):
        return torch.einsum("bsd,dhk->bshk", _mix(x, xs, p[mu]),
                            p[w].to(dt))

    r, k, v, g = (proj("mu_" + n, "w_" + n) for n in "rkvg")
    xw = _mix(x, xs, p["mu_w"])
    lora = torch.einsum("bsr,rhk->bshk",
                        torch.tanh(xw @ p["lora_a"].to(dt)),
                        p["lora_b"].to(dt))
    log_w = -torch.exp(torch.clamp(p["w0"].float() + lora.float(), -8.0,
                                   4.0))
    if decode:
        y, new_state = recurrent_step(
            r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], state, u=p["u"],
            chunk=cfg.chunk_size, include_diag="bonus")
        y = y[:, None]
    else:
        y, new_state = chunked_linear_attention(
            r, k, v, log_w, u=p["u"], chunk=cfg.chunk_size,
            initial_state=state, include_diag="bonus")
    # per-head group norm (population variance), then the gate
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = yf * p["ln_x_scale"].float()
    y = yf.to(dt) * F.silu(g)
    out = torch.einsum("bshk,hkd->bsd", y, p["w_o"].to(dt))
    if dist is not None:
        out = dist.from_parallel(out, True, seq)
    return out, (new_state, x[:, -1])


def channel_mix(cfg, p, x, masks=None, x_last=None, dist=None, seq=False):
    """Square-ReLU channel mix, the BLaST-sparse MLP. Returns (y,
    new_x_last). Under ``dist`` ``mlp2``'s tensor-parallel path, the
    receptance (``w_recept`` whole) applied after its sum; with ``seq``
    on this rank's S shard."""
    xs = _seq_shift(x, dist) if seq else _shift(x, x_last)
    xk = _mix(x, xs, p["mu_k"])
    xr = _mix(x, xs, p["mu_r"])
    tp = dict(dist=dist, d_ff=cfg.d_ff, seq=seq) if dist is not None else {}
    y = sm.mlp2(xk, p["w_in"], p["w_out"], act="relu", masks=masks,
                spec=cfg.blast, square=True, **tp)
    recept = torch.sigmoid(xr @ p["w_recept"].to(x.dtype))
    return recept * y, x[:, -1]


def _layer(cfg, p_l, x, m_l, dist=None, seq=False):
    h = layernorm(x, p_l["ln1_scale"], p_l["ln1_bias"])
    x = x + time_mix(cfg, p_l["tmix"], h, dist=dist, seq=seq)[0]
    h = layernorm(x, p_l["ln2_scale"], p_l["ln2_bias"])
    return x + channel_mix(cfg, p_l["mlp"], h, masks=m_l, dist=dist,
                           seq=seq)[0]


def forward(cfg, params, tokens, *, masks=None, dist=None, **_):
    """Training forward: tokens (B,S) -> (logits (B,S,V) f32, 0.0), the
    rank's vocab shard under ``dist`` (sequence-parallel where
    ``seq_split`` allows it). With ``cfg.remat`` each layer is recomputed
    in the backward."""
    check_training(cfg, dist)
    from repro_torch.models.transformer import (_layer_masks, _unbind,
                                                embed_inputs,
                                                logits_from_hidden)
    b, s = tokens.shape
    seq = dist is not None and dist.seq_split((b, s, cfg.d_model))
    x = embed_inputs(cfg, params, tokens, dist=dist, seq=seq)
    remat = cfg.remat and torch.is_grad_enabled()
    lay = _unbind(params["layers"])
    for p_l, m_l in zip(lay, _unbind(_layer_masks(masks, "layers"),
                                     len(lay))):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, cfg, p_l, x, m_l, dist, seq, use_reentrant=False)
        else:
            x = _layer(cfg, p_l, x, m_l, dist, seq)
    return logits_from_hidden(cfg, params, x, dist, seq), 0.0


# ------------------------------------------------------------------ decode
def _local_heads(cfg, dist) -> int:
    h = _heads(cfg)[0]
    return h // dist.tp if dist is not None and dist.shards(h) else h


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", dist=None):
    """Per layer: the f32 recurrent state (B,H,dk,dk) and the last
    token's time-mix and channel-mix inputs (B,D) in ``dtype`` (H the
    rank's heads under ``dist``). ``max_len`` does not enter: the state
    is O(1) in the length."""
    h, dk = _local_heads(cfg, dist), cfg.head_dim
    n, d = cfg.num_layers, cfg.d_model
    return {
        "state": torch.zeros((n, batch, h, dk, dk), dtype=torch.float32,
                             device=device),
        "x_tmix": torch.zeros((n, batch, d), dtype=dtype, device=device),
        "x_cmix": torch.zeros((n, batch, d), dtype=dtype, device=device),
    }


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   dist=None):
    """Shapes and dtypes of ``init_cache``'s state (no allocation)."""
    from repro_torch.models.params import AbstractParam
    h, dk = _local_heads(cfg, dist), cfg.head_dim
    n, d = cfg.num_layers, cfg.d_model
    return {"state": AbstractParam((n, batch, h, dk, dk), torch.float32),
            "x_tmix": AbstractParam((n, batch, d), dtype),
            "x_cmix": AbstractParam((n, batch, d), dtype)}


def decode_step(cfg, params, cache, tokens, pos, *, dist=None, **_):
    """One token through every layer's recurrence. tokens (B,1); ``pos``
    does not enter (the state carries the position). Returns (logits
    (B,1,V) f32, the rank's vocab shard under ``dist``, cache), the cache
    updated in place."""
    check_serving(cfg, dist)
    from repro_torch.models.transformer import (_layer_view, embed_inputs,
                                                logits_from_hidden)
    x = embed_inputs(cfg, params, tokens, dist=dist)
    st, xt, xc = cache["state"], cache["x_tmix"], cache["x_cmix"]
    for i in range(cfg.num_layers):
        p_l = _layer_view(params["layers"], i)
        h = layernorm(x, p_l["ln1_scale"], p_l["ln1_bias"])
        a, (new_st, new_xt) = time_mix(cfg, p_l["tmix"], h, state=st[i],
                                       x_last=xt[i], decode=True, dist=dist)
        x = x + a
        h = layernorm(x, p_l["ln2_scale"], p_l["ln2_bias"])
        m, new_xc = channel_mix(cfg, p_l["mlp"], h, x_last=xc[i], dist=dist)
        x = x + m
        st[i] = new_st
        xt[i] = new_xt.to(xt.dtype)
        xc[i] = new_xc.to(xc.dtype)
    return logits_from_hidden(cfg, params, x, dist), cache
