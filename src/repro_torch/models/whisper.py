"""whisper-large-v3, the ``audio`` family (port of
``repro/models/whisper.py``): an encoder-decoder transformer backbone.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model). Positions are learned
(``pos_enc``, ``pos_dec``; no rope). Encoder layers attend
bidirectionally; decoder layers interleave causal self-attention with
cross-attention into the encoder memory. BLaST prunes both stacks'
two-matrix MLPs (``mlp2``: GELU, with biases), whose packed weights run
through the ``bspmm`` kernel (``core/sparse_mlp.py::mlp2``).

The stacks are stored layer-stacked, as in the reference; its
``lax.scan`` over them becomes a Python loop over per-layer views, and
with ``cfg.remat`` each layer of the training forward is recomputed in
the backward (``torch.utils.checkpoint``). Serving decodes token by
token (``serving/serve_loop.py``): ``prefill_cross`` runs the encoder
once and projects every decoder layer's cross K/V into the ``ck``/``cv``
slots of the cache, which decode only reads; the self-attention cache is
updated in place.

Under ``dist=`` (tensor parallelism, the transformer's layout): each
rank computes its query heads and kv heads in all three attention
blocks (``attention.shard_local``; whisper-large-v3 pads 20 heads to 32,
so at model 2 rank 1 holds 4 live heads and 12 padded ones) and its
d_ff slice of both stacks' MLPs (``sparse_mlp.mlp2``); the token
embedding is the vocab-split masked lookup and the untied head gives
vocab-sharded logits. With ``sp`` the encoder's and the decoder's
streams each split along S where their length divides the model axis,
after the learned positions are added to the whole sequence (the
reference's ``constrain_seq`` points; so those positions' gradient is
whole); the encoder memory is gathered whole before any rank projects
its cross-attention K/V, and ``prefill_cross`` fills the rank's kv heads
of ``ck``/``cv``. The decode step keeps the replicated stream.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import sparse_mlp as sm
from repro_torch.distributed.context import check_serving, check_training
from repro_torch.models import attention as attn
from repro_torch.models.layers import norm
from repro_torch.models.params import DTYPES, ParamSpec
from repro_torch.models.transformer import (_attention, _heads_out,
                                            _layer_masks, _layer_view,
                                            _norm_specs, _stack_specs, _unbind,
                                            embed_inputs, logits_from_hidden,
                                            mlp_param_specs)

MAX_POS = 16_384   # backbone scaled to the assigned shapes (prefill 16k)


def enc_layer_specs(cfg) -> dict:
    specs = {}
    specs.update(_norm_specs(cfg, "ln_attn"))
    specs["attn"] = attn.attn_param_specs(cfg)
    specs.update(_norm_specs(cfg, "ln_mlp"))
    specs["mlp"] = mlp_param_specs(cfg)
    return specs


def dec_layer_specs(cfg) -> dict:
    specs = enc_layer_specs(cfg)
    specs.update(_norm_specs(cfg, "ln_cross"))
    specs["cross"] = attn.attn_param_specs(cfg, cross=True)
    return specs


def param_specs(cfg) -> dict:
    d = cfg.d_model
    specs = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                           init="embed"),
        "pos_enc": ParamSpec((MAX_POS, d), (None, "embed"), init="embed"),
        "pos_dec": ParamSpec((MAX_POS, d), (None, "embed"), init="embed"),
        "encoder": _stack_specs(enc_layer_specs(cfg),
                                cfg.num_encoder_layers),
        "decoder": _stack_specs(dec_layer_specs(cfg), cfg.num_layers),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab"),
                             init="embed"),
    }
    specs.update(_norm_specs(cfg, "ln_f"))
    specs.update(_norm_specs(cfg, "ln_enc_f"))
    return specs


def zero_padded_heads(cfg, params, dist=None) -> None:
    """Zero the padded query heads of the encoder's self-attention and of
    the decoder's self- and cross-attention, in place
    (``attention.zero_padded_heads``; ``params`` this rank's shard under
    ``dist``)."""
    for stack, block in (("encoder", "attn"), ("decoder", "attn"),
                         ("decoder", "cross")):
        attn.zero_padded_heads(cfg, params[stack][block], dist)


def sparse_paths(cfg) -> list[str]:
    return ["encoder/mlp/w_in", "encoder/mlp/w_out",
            "decoder/mlp/w_in", "decoder/mlp/w_out"]


def dense_layer_flags(cfg) -> dict:
    """Per-stack (layers,) bool flags on the CPU, keyed by stack: the last
    ``dense_last`` layers of EACH stack stay dense (paper §5.4.4)."""
    def flags(n):
        return torch.arange(n) >= (n - cfg.blast.dense_last)
    return {"encoder": flags(cfg.num_encoder_layers),
            "decoder": flags(cfg.num_layers)}


def _mlp(cfg, p, x, m, dist=None, seq=False):
    tp = dict(dist=dist, d_ff=cfg.d_ff, seq=seq) if dist is not None else {}
    return sm.mlp2(x, p["w_in"], p["w_out"], p.get("b_in"), p.get("b_out"),
                   act=cfg.mlp_act, masks=m, spec=cfg.blast, **tp)


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _split(x, dist):
    """(``x``, or this rank's S shard of it where ``dist.seq_split``
    allows it; whether it was split): the reference's ``constrain_seq``
    after the learned positions are added, so their gradient is whole."""
    seq = dist is not None and dist.seq_split(x)
    return (dist.scatter_to_seq(x) if seq else x), seq


def _enc_block(cfg, p, m, x, positions, dist=None, seq=False):
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    x = x + _attention(cfg, p["attn"], h, positions, dist, seq,
                       causal=False)
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    return x + _mlp(cfg, p["mlp"], h, m, dist, seq)


def _run_layers(cfg, stack, masks, x, block, *args):
    """``block(cfg, p_l, m_l, x, *args)`` over every layer of a stacked
    ``stack``; each layer recomputed in the backward under
    ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    lay = _unbind(stack)
    for p_l, m_l in zip(lay, _unbind(masks, len(lay))):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block, cfg, p_l, m_l, x, *args, use_reentrant=False)
        else:
            x = block(cfg, p_l, m_l, x, *args)
    return x


def encode(cfg, params, frames, *, masks=None, dist=None):
    """frames (B, S_enc, D), precomputed embeddings (the stub frontend)
    -> the encoder memory (B, S_enc, D) in the compute dtype. Under
    ``dist`` the memory comes out whole on every rank (gathered along S
    where the encoder's stream was split), ready for the rank's
    cross-attention K/V projections, whose partial gradients its
    backward sums over the model axis (``DistContext.to_parallel``)."""
    b, s, _ = frames.shape
    x = frames.to(DTYPES[cfg.compute_dtype])
    x, seq = _split(x + params["pos_enc"][:s].to(x.dtype), dist)
    x = _run_layers(cfg, params["encoder"], _layer_masks(masks, "encoder"),
                    x, _enc_block, _positions(b, s, x.device), dist, seq)
    x = norm(cfg.norm_kind, x, params["ln_enc_f_scale"],
             params.get("ln_enc_f_bias"))
    if dist is None:
        return x
    return dist.to_parallel(x, dist.shards(attn.eff_heads(cfg)[0]), seq)


def _dec_block(cfg, p, m, x, positions, memory, mem_positions, dist=None,
               seq=False):
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    x = x + _attention(cfg, p["attn"], h, positions, dist, seq,
                       causal=True)
    h = norm(cfg.norm_kind, x, p["ln_cross_scale"], p.get("ln_cross_bias"))
    x = x + _attention(cfg, p["cross"], h, positions, dist, seq,
                       causal=False, kv_src=memory,
                       kv_positions=mem_positions)
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    return x + _mlp(cfg, p["mlp"], h, m, dist, seq)


def _embed(cfg, params, tokens, pos_dec, dist=None):
    """Token embeddings plus the learned positions, whole on every rank:
    under ``dist`` the vocab-split table's masked lookup and its sum
    over the model axis (``transformer.embed_inputs``)."""
    x = embed_inputs(cfg, params, tokens, dist=dist)
    return x + pos_dec.to(x.dtype)


def forward(cfg, params, tokens, *, frames=None, masks=None, dist=None,
            **_):
    """Training forward: frames (B, S_enc, D) and tokens (B, S_dec) ->
    (logits (B, S_dec, V) f32, 0.0). Under ``dist`` the rank's shard
    computes its heads and d_ff slice; with ``sp`` the encoder's and the
    decoder's streams split along S where each divides the model axis
    (the reference's ``constrain_seq`` points), and the logits are the
    rank's vocab shard."""
    check_training(cfg, dist)
    if frames is None:
        raise ValueError("whisper's forward needs frames (B, S_enc, "
                         "d_model)")
    memory = encode(cfg, params, frames, masks=masks, dist=dist)
    b, s = tokens.shape
    x, seq = _split(_embed(cfg, params, tokens, params["pos_dec"][:s], dist),
                    dist)
    x = _run_layers(cfg, params["decoder"], _layer_masks(masks, "decoder"),
                    x, _dec_block, _positions(b, s, x.device), memory,
                    _positions(b, memory.shape[1], x.device), dist, seq)
    return logits_from_hidden(cfg, params, x, dist, seq), 0.0


def prefill_cross(cfg, params, frames, *, masks=None, dtype=torch.bfloat16,
                  dist=None):
    """Run the encoder and project every decoder layer's cross K/V: the
    'ck'/'cv' slots of the decode cache, (layers, B, S_enc, KV, hd) in
    ``dtype``, written layer by layer into one allocation each (KV the
    rank's kv heads under ``dist``)."""
    check_serving(cfg, dist)
    memory = encode(cfg, params, frames, masks=masks, dist=dist)
    b, s, _ = memory.shape
    kv = attn.local_heads(cfg, dist)[3]
    shape = (cfg.num_layers, b, s, kv, cfg.head_dim)
    ck = torch.empty(shape, dtype=dtype, device=memory.device)
    cv = torch.empty(shape, dtype=dtype, device=memory.device)
    dt = memory.dtype
    for i in range(cfg.num_layers):
        p = attn.shard_local(cfg, _layer_view(params["decoder"]["cross"], i),
                             dist)
        k = torch.einsum("bsd,dhk->bshk", memory, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", memory, p["wv"].to(dt))
        if cfg.qkv_bias:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        ck[i] = k
        cv[i] = v
    return ck, cv


# ------------------------------------------------------------------ decode
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", dist=None):
    """The decoder's self-attention cache 'k'/'v' (layers, batch, max_len,
    KV, hd; KV the rank's kv heads under ``dist``). The encoder memory
    'ck'/'cv' that ``decode_step`` also reads is ``prefill_cross``'s
    pair, which the caller adds (``serve_loop`` does); the reference's
    ``max_len``-long placeholders for it are not allocated."""
    kv = attn.local_heads(cfg, dist)[3]
    shape = (cfg.num_layers, batch, max_len, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   enc_len: int | None = None, dist=None):
    """Shapes and dtypes of the whole decode cache (no allocation), as
    the reference lays it out: the self-attention 'k'/'v' of
    ``init_cache`` and the encoder memory 'ck'/'cv' of ``enc_len``
    (default ``max_len``) positions that ``prefill_cross`` makes (KV the
    rank's kv heads under ``dist``)."""
    from repro_torch.models.params import AbstractParam
    kv = attn.local_heads(cfg, dist)[3]
    n = cfg.num_layers
    self_ = AbstractParam((n, batch, max_len, kv, cfg.head_dim), dtype)
    cross = AbstractParam((n, batch, enc_len or max_len, kv, cfg.head_dim),
                          dtype)
    return {"k": self_, "v": self_, "ck": cross, "cv": cross}


def decode_step(cfg, params, cache, tokens, pos, *, masks=None, dist=None,
                **_):
    """One decoder token per lane. tokens (B,1); ``pos`` an int, the cache
    slot and the learned position of every lane (a synchronized batch, as
    in the reference). Self-attention writes the cache in place;
    cross-attention reads 'ck'/'cv'. Returns (logits (B,1,V) f32,
    cache); under ``dist`` the rank's heads and d_ff slice run on the
    replicated stream, as the reference's cache steps keep it, and the
    logits are the rank's vocab shard."""
    check_serving(cfg, dist)
    p0 = min(max(int(pos), 0), MAX_POS - 1)  # dynamic_slice clamps too
    x = _embed(cfg, params, tokens, params["pos_dec"][p0:p0 + 1], dist)
    dmasks = _layer_masks(masks, "decoder")
    for i in range(cfg.num_layers):
        p = _layer_view(params["decoder"], i)
        m = None if dmasks is None else _layer_view(dmasks, i)
        h = norm(cfg.norm_kind, x, p["ln_attn_scale"],
                 p.get("ln_attn_bias"))
        a = attn.decode_attention(cfg, attn.shard_local(cfg, p["attn"], dist),
                                  h, cache["k"][i], cache["v"][i], pos)[0]
        x = x + _heads_out(cfg, a, dist)
        h = norm(cfg.norm_kind, x, p["ln_cross_scale"],
                 p.get("ln_cross_bias"))
        c = attn.decode_attention(cfg, attn.shard_local(cfg, p["cross"], dist),
                                  h, cache["ck"][i], cache["cv"][i], pos,
                                  cross=True)[0]
        x = x + _heads_out(cfg, c, dist)
        h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
        x = x + _mlp(cfg, p["mlp"], h, m, dist)
    return logits_from_hidden(cfg, params, x), cache
