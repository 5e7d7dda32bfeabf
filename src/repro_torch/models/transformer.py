"""Decoder-only transformer LM, the dense, MoE and VLM families (port of
``repro/models/transformer.py``, single device): the training forward
and the serving steps over the contiguous cache and the paged pool. An
MoE model's MLP is ``models/moe.py``; its load-balance aux term is summed
over the layers of the training forward. A VLM's training forward takes
precomputed patch embeddings (the stub vision frontend) in place of its
first ``num_patches`` token embeddings; decode and the engine stay
text-only, as in the reference.

Params are nested dicts whose layer leaves are stacked on a leading
layer axis, exactly as in the reference; the reference's ``lax.scan``
over that axis becomes a Python loop over per-layer views, and BLaST
masks ride along as per-layer views of the stacked mask tree.
gemma2-style ``local_global`` stacks run as (local, global) pairs. With
``cfg.remat`` each layer of the training forward is recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
keeping what ``layers.remat_policy`` names): this changes memory, not
numbers. The KV
caches are updated in place (models/attention.py).

Tensor-parallel serving (``dist=``, a
``distributed.context.DistContext``; the dense family with either MLP,
the VLM and the MoE family; whisper reuses these pieces,
``models/whisper.py``): every rank holds its shard of the params
(``serving/export.py::shard_params``) and runs the same forward on the
replicated residual stream. The embedding is vocab-sharded (a masked
local lookup, then an all-reduce; replicated where the vocabulary does
not divide the model axis, GPT-2's 50,257); attention computes the
rank's query heads and the kv heads they read
(``attention.local_heads``; every head on every rank where they do not
divide it, GPT-2 XL's 25), and its row-parallel ``wo`` is followed by an
all-reduce; the MLP is ``sparse_mlp.glu_mlp``'s or ``mlp2``'s
tensor-parallel path (``b_out`` added once, after the sum), or an MoE
layer's expert parallel one (``moe.moe_forward(axis_name=dist)``: every
rank routes the whole stream, computes its E/tp experts and the
replicated shared experts, one all-reduce of the experts' partial sums);
the logits come out vocab-sharded (each rank's slice of the vocabulary,
in rank order), so a caller reduces them with
``DistContext.vocab_argmax`` or gathers them with ``all_gather``. A
cache built with ``dist=`` holds the rank's kv heads only.

The training forward (``forward`` with ``masks=`` and ``dist=``, the
sharded train step) runs the same layout through the conjugate pairs of
``DistContext``: ``copy_to_model`` on the normed input of every
column-parallel product (attention's projections, the MLP's gate/up, the
vocab-sharded head), ``reduce_from_model`` after every row-parallel one
(``wo``, the MLP's down projection) and after the masked embedding
lookup. The logits stay vocab-sharded (``core/distill.py`` reduces the
cross-entropy over the shards); a tied embedding takes both its lookup's
and its head's gradient on its own rows.

Sequence parallelism (``DistContext.sp``, on by default as in the
reference; the training forward and the full-sequence prefill only):
where ``seq_split`` allows it the residual stream between the products
is this rank's S shard. The embedding reduce-scatters where it
all-reduces; each norm acts on the shard, which ``gather_from_seq``
makes whole along S before attention, the MLP and the head (RoPE sees
the gathered sequence's positions); ``wo`` and the down projection
reduce-scatter where they all-reduce. A VLM's patches land on the
positions [0, num_patches) of the whole sequence, in whichever shards
hold them. The cache steps keep the replicated stream, as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.core import sparse_mlp as sm
from repro_torch.core.packing import PackedBCSC
from repro_torch.distributed.context import check_serving, check_training
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import norm, remat_policy, softcap
from repro_torch.models.params import DTYPES, ParamSpec


# -------------------------------------------------------------- param spec
def _norm_specs(cfg, name):
    d = {name + "_scale": ParamSpec((cfg.d_model,), ("embed",),
                                    init="zeros" if cfg.norm_kind ==
                                    "rmsnorm" else "ones")}
    if cfg.norm_kind == "layernorm":
        d[name + "_bias"] = ParamSpec((cfg.d_model,), ("embed",),
                                      init="zeros")
    return d


def mlp_param_specs(cfg) -> dict:
    if cfg.is_moe:
        return moe_mod.moe_param_specs(cfg)
    d, f = cfg.d_model, cfg.d_ff
    down_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    if cfg.mlp_kind == "glu":
        return {
            "w_gate": ParamSpec((d, f), ("embed", "ff")),
            "w_up": ParamSpec((d, f), ("embed", "ff")),
            "w_down": ParamSpec((f, d), ("ff", "embed"), scale=down_scale),
        }
    return {
        "w_in": ParamSpec((d, f), ("embed", "ff")),
        "b_in": ParamSpec((f,), ("ff",), init="zeros"),
        "w_out": ParamSpec((f, d), ("ff", "embed"), scale=down_scale),
        "b_out": ParamSpec((d,), ("embed",), init="zeros"),
    }


def layer_param_specs(cfg) -> dict:
    specs = {}
    specs.update(_norm_specs(cfg, "ln_attn"))
    specs["attn"] = attn.attn_param_specs(cfg)
    specs.update(_norm_specs(cfg, "ln_mlp"))
    specs["mlp"] = mlp_param_specs(cfg)
    return specs


def _stack_specs(specs: dict, n: int) -> dict:
    """Prepend a stacked 'layers' dim to every leaf."""
    return {k: (_stack_specs(v, n) if isinstance(v, dict) else
                dataclasses.replace(v, shape=(n,) + v.shape,
                                    axes=("layers",) + v.axes))
            for k, v in specs.items()}


def n_stacks(cfg) -> tuple[int, int]:
    """(stack length, layers per stack step)."""
    if cfg.layer_pattern == "local_global":
        if cfg.num_layers % 2:
            raise ValueError("local_global needs an even layer count")
        return cfg.num_layers // 2, 2
    return cfg.num_layers, 1


def param_specs(cfg) -> dict:
    ns, _ = n_stacks(cfg)
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), init="embed"),
    }
    if cfg.layer_pattern == "local_global":
        specs["layers_local"] = _stack_specs(layer_param_specs(cfg), ns)
        specs["layers_global"] = _stack_specs(layer_param_specs(cfg), ns)
    else:
        specs["layers"] = _stack_specs(layer_param_specs(cfg), ns)
    specs.update(_norm_specs(cfg, "ln_f"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), init="embed")
    return specs


def zero_padded_heads(cfg, params, dist=None) -> None:
    """Zero the padded query heads of every layer stack, in place
    (``attention.zero_padded_heads``; ``params`` this rank's shard under
    ``dist``)."""
    for stack in ("layers", "layers_local", "layers_global"):
        if stack in params:
            attn.zero_padded_heads(cfg, params[stack]["attn"], dist)


def sparse_paths(cfg) -> list[str]:
    """Param-tree paths of the BLaST-sparsified (stacked) weights."""
    stacks = (["layers_local", "layers_global"]
              if cfg.layer_pattern == "local_global" else ["layers"])
    if cfg.mlp_kind == "glu" or cfg.is_moe:
        leaves = ["mlp/w_gate", "mlp/w_up", "mlp/w_down"]
        if cfg.is_moe and cfg.num_shared_experts:
            leaves += ["mlp/ws_gate", "mlp/ws_up", "mlp/ws_down"]
    else:
        leaves = ["mlp/w_in", "mlp/w_out"]
    return [f"{s}/{leaf}" for s in stacks for leaf in leaves]


def dense_layer_flags(cfg) -> torch.Tensor:
    """(stack,) bool on the CPU: True where the MLP stays dense (the last
    ``dense_last`` layers, paper §5.4.4). For paired stacks the flag
    covers the pair."""
    ns, per = n_stacks(cfg)
    n_dense = math.ceil(cfg.blast.dense_last / per)
    return torch.arange(ns) >= (ns - n_dense)


# ----------------------------------------------------------------- forward
def _layer_view(tree, i: int):
    """Entry ``i`` of the leading layer axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return tree.layer(i)
    return tree[i]


def _unbind(tree, n: int | None = None) -> list:
    """The per-layer trees of a stacked tree, by one ``unbind`` of each
    leaf: its backward stacks the 16 layer gradients once, where
    indexing each layer would add a zero-filled full-size gradient per
    layer. A None tree gives ``n`` Nones."""
    if tree is None:
        return [None] * n
    cols = {k: _unbind(v) if isinstance(v, dict) else
            [v.layer(i) for i in range(v.idx.shape[0])]
            if isinstance(v, PackedBCSC) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _layer_masks(masks: dict | None, stack: str) -> dict | None:
    """The stacked masks of one stack's MLP, keyed by leaf name."""
    if not masks:
        return None
    prefix = stack + "/mlp/"
    out = {k[len(prefix):]: v for k, v in masks.items()
           if k.startswith(prefix)}
    return out or None


def mlp_forward(cfg, p, x, masks=None, dist=None, seq=False):
    """-> (MLP output, aux loss: the MoE layer's, else 0.0). Under
    ``dist`` the GLU and the two-matrix MLP are tensor-parallel and the
    MoE layer expert-parallel (the reference's ``_moe_shardmap``), their
    output replicated, or with ``seq`` this rank's S shard, as their
    input is."""
    if dist is not None and cfg.is_moe:
        return moe_mod.moe_forward(cfg, p, x, masks=masks, axis_name=dist,
                                   seq=seq)
    if cfg.is_moe:
        return moe_mod.moe_forward(cfg, p, x, masks=masks)
    tp = dict(dist=dist, d_ff=cfg.d_ff, seq=seq) if dist is not None else {}
    if cfg.mlp_kind == "glu":
        y = sm.glu_mlp(x, p["w_gate"], p["w_up"], p["w_down"],
                       act=cfg.mlp_act, masks=masks, spec=cfg.blast, **tp)
    else:
        y = sm.mlp2(x, p["w_in"], p["w_out"], p.get("b_in"),
                    p.get("b_out"), act=cfg.mlp_act, masks=masks,
                    spec=cfg.blast, **tp)
    return y, 0.0


def _heads_out(cfg, out, dist, seq=False):
    """Attention's output: the sum over the model axis of each rank's
    row-parallel ``wo`` product where the query heads are split; with
    ``seq`` this rank's S shard of it (``DistContext.from_parallel``)."""
    if dist is None:
        return out
    return dist.from_parallel(out, dist.shards(attn.eff_heads(cfg)[0]), seq)


def _attention(cfg, p, h, positions, dist=None, seq=False, **kw):
    """Full-sequence attention (``attention.multihead_attention``, ``kw``
    its options) of the normed stream ``h`` on this rank's heads
    (``attention.shard_local``), its input gathered along S and its
    output summed over the model axis (reduce-scattered to the S shard
    under ``seq``, ``_heads_out``)."""
    if dist is not None:
        h = dist.to_parallel(h, dist.shards(attn.eff_heads(cfg)[0]), seq)
    a = attn.multihead_attention(cfg, attn.shard_local(cfg, p, dist), h,
                                 positions, **kw)[0]
    return _heads_out(cfg, a, dist, seq)


def _block(cfg, p, x, positions, masks, window, dist=None, seq=False):
    """One pre-norm transformer block (full causal attention) -> (x,
    aux). With ``seq`` the stream ``x`` is this rank's S shard: each norm
    acts on the shard, whose result is gathered along S before attention
    and before the MLP, and their outputs come back reduce-scattered."""
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    x = x + _attention(cfg, p["attn"], h, positions, dist, seq,
                       causal=True, window=window)
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    m, aux = mlp_forward(cfg, p["mlp"], h, masks, dist=dist, seq=seq)
    return x + m, aux


def forward(cfg, params, tokens, *, masks=None, patch_embeds=None,
            dist=None):
    """Training/prefill forward: tokens (B,S) int -> (logits (B,S,V) f32,
    aux loss). ``masks`` is the BLaST mask tree (None: dense);
    ``patch_embeds`` (B, num_patches, D) replace a VLM's first token
    embeddings (``embed_inputs``); under ``dist`` the logits are the
    rank's vocab shard. Under ``dist`` with ``sp`` the residual stream
    between the layers is this rank's S shard wherever ``seq_split``
    allows it (the reference's ``constrain_seq``)."""
    check_training(cfg, dist)
    b, s = tokens.shape
    seq = dist is not None and dist.seq_split((b, s, cfg.d_model))
    x = embed_inputs(cfg, params, tokens, patch_embeds, dist=dist, seq=seq)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    kept = remat_policy(cfg) if remat else None
    ckpt_kw = {} if kept is None else {"context_fn": kept}

    def layer(p_l, m_l, x, window):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                _block, cfg, p_l, x, positions, m_l, window, dist, seq,
                use_reentrant=False, **ckpt_kw)
        return _block(cfg, p_l, x, positions, m_l, window, dist, seq)

    aux = 0.0
    if cfg.layer_pattern == "local_global":
        loc = _unbind(params["layers_local"])
        glb = _unbind(params["layers_global"])
        m_loc = _unbind(_layer_masks(masks, "layers_local"), len(loc))
        m_glb = _unbind(_layer_masks(masks, "layers_global"), len(glb))
        for p_l, m_l, p_g, m_g in zip(loc, m_loc, glb, m_glb):
            x, a1 = layer(p_l, m_l, x, cfg.sliding_window)
            x, a2 = layer(p_g, m_g, x, 0)
            aux = aux + a1 + a2
    else:
        lay = _unbind(params["layers"])
        for p_l, m_l in zip(lay, _unbind(_layer_masks(masks, "layers"),
                                         len(lay))):
            x, a = layer(p_l, m_l, x, cfg.sliding_window)
            aux = aux + a
    return logits_from_hidden(cfg, params, x, dist, seq), aux


def embed_inputs(cfg, params, tokens, patch_embeds=None, dist=None,
                 seq=False):
    """Token embeddings (B,S,D) in the compute dtype; with
    ``patch_embeds`` (B, num_patches, D) and a config that has patches,
    the first ``num_patches`` positions are the patches instead (under
    ``seq`` those of them that fall in this rank's S shard). Under
    ``dist`` with a vocab-sharded table each rank looks up the tokens in
    its slice, zeros the rest, and the all-reduce sums in the one rank's
    row that holds each token (exact). With ``seq`` (sequence
    parallelism) the result is this rank's S shard: a reduce-scatter in
    place of the all-reduce, or the slice of a replicated lookup."""
    if dist is not None and dist.shards(cfg.vocab_size):
        table = params["embed"]
        n = table.shape[0]
        local = tokens.long() - dist.model_rank * n
        mine = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)].to(DTYPES[cfg.compute_dtype])
        x = dist.from_parallel(torch.where(mine[..., None], x, 0.0), True,
                               seq)
    else:
        x = params["embed"][tokens.long()].to(DTYPES[cfg.compute_dtype])
        if seq:
            x = dist.from_parallel(x, False, seq)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    if patch_embeds is not None and cfg.num_patches:
        # the patches hold positions [0, num_patches) of the whole
        # sequence; under ``seq`` this shard starts at lo
        lo = dist.model_rank * x.shape[1] if seq else 0
        k = min(max(cfg.num_patches - lo, 0), x.shape[1])
        if k:
            x = torch.cat([patch_embeds[:, lo:lo + k].to(x.dtype),
                           x[:, k:]], dim=1)
    return x


def logits_from_hidden(cfg, params, x, dist=None, seq=False):
    """Final norm + (tied) LM head -> f32 logits (a sharded rank's head
    is its vocab slice, so its logits are too). With ``seq`` the norm
    acts on this rank's S shard, gathered along S before the head."""
    xf = norm(cfg.norm_kind, x, params["ln_f_scale"], params.get("ln_f_bias"))
    if dist is not None:
        xf = dist.to_parallel(xf, dist.shards(cfg.vocab_size), seq)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = xf @ head.to(xf.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", dist=None):
    """Contiguous KV cache (layers, batch, max_len, KV, hd): one dense
    slab row per lane (KV the rank's kv heads under ``dist``)."""
    ns, per = n_stacks(cfg)
    kv = attn.local_heads(cfg, dist)[3]
    shape = (ns * per, batch, max_len, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   dist=None):
    """Shapes and dtypes of ``init_cache``'s K and V (no allocation; KV
    the rank's kv heads under ``dist``)."""
    from repro_torch.models.params import AbstractParam
    ns, per = n_stacks(cfg)
    kv = attn.local_heads(cfg, dist)[3]
    shape = (ns * per, batch, max_len, kv, cfg.head_dim)
    return {"k": AbstractParam(shape, dtype), "v": AbstractParam(shape, dtype)}


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda", dist=None):
    """Paged KV pool (layers, n_pages, page_size, KV, hd), SHARED by every
    lane; a pool page is allocated across all layers at once, so block
    tables are layer-independent. Under ``dist`` KV is the rank's kv
    heads."""
    ns, per = n_stacks(cfg)
    kv = attn.local_heads(cfg, dist)[3]
    shape = (ns * per, n_pages, page_size, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _run_stack(cfg, params, cache, x, attn_fn, dist=None):
    """Run every layer with a pluggable attention core
    ``attn_fn(p_attn, h, ck, cv, window) -> out`` that reads and writes
    this layer's cache views ``ck``/``cv`` in place. Returns hidden."""
    def one(window, p_l, x, li):
        h = norm(cfg.norm_kind, x, p_l["ln_attn_scale"],
                 p_l.get("ln_attn_bias"))
        a = attn_fn(attn.shard_local(cfg, p_l["attn"], dist), h,
                    cache["k"][li], cache["v"][li], window)
        x = x + _heads_out(cfg, a, dist)
        h = norm(cfg.norm_kind, x, p_l["ln_mlp_scale"],
                 p_l.get("ln_mlp_bias"))
        return x + mlp_forward(cfg, p_l["mlp"], h, dist=dist)[0]

    ns, _ = n_stacks(cfg)
    for i in range(ns):
        if cfg.layer_pattern == "local_global":
            x = one(cfg.sliding_window,
                    _layer_view(params["layers_local"], i), x, 2 * i)
            x = one(0, _layer_view(params["layers_global"], i), x, 2 * i + 1)
        else:
            x = one(cfg.sliding_window, _layer_view(params["layers"], i),
                    x, i)
    return x


def decode_step(cfg, params, cache, tokens, pos, *, offsets=None,
                dist=None):
    """One decode step over the contiguous cache. tokens (B,1); ``pos``
    the cache slot, an int (synchronized batch) or a (B,) tensor
    (per-lane frontiers; slots >= max_len drop the write); ``offsets``
    (B,) makes the batch ragged. Returns (logits (B,1,V) f32, cache),
    the cache updated in place."""
    check_serving(cfg, dist)
    x = embed_inputs(cfg, params, tokens, dist=dist)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.decode_attention(cfg, p_a, h, ck, cv, pos,
                                     window=window, offsets=offsets)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn, dist)
    return logits_from_hidden(cfg, params, x), cache


def prefill_chunk(cfg, params, cache, tokens, slot, offsets, *,
                  lane_mask=None, dist=None):
    """Batched chunked prefill over the contiguous cache: the (B, C)
    chunk of right-aligned prompt tokens writes K/V at slots [slot,
    slot+C); lanes outside ``lane_mask`` keep their rows. Returns (logits
    (B,C,V) f32, cache), the cache updated in place."""
    check_serving(cfg, dist)
    x = embed_inputs(cfg, params, tokens, dist=dist)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.chunk_attention(cfg, p_a, h, ck, cv, slot, offsets,
                                    window=window, lane_mask=lane_mask)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn, dist)
    return logits_from_hidden(cfg, params, x), cache


def paged_decode_step(cfg, params, cache, tokens, pos, block_tables, *,
                      read_pages: int, offsets=None, dist=None):
    """One decode step over the paged pool. tokens (B,1); pos (B,) logical
    cache slots (parked lanes carry ``max_pages * page_size``: the write
    drops); block_tables (B, max_pages) int32; attention reads each
    lane's first ``read_pages`` pages. Returns (logits (B,1,V) f32,
    cache), the cache updated in place."""
    check_serving(cfg, dist)
    x = embed_inputs(cfg, params, tokens, dist=dist)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.paged_decode_attention(
            cfg, p_a, h, ck, cv, block_tables, pos, read_pages=read_pages,
            window=window, offsets=offsets)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn, dist)
    return logits_from_hidden(cfg, params, x), cache


def paged_prefill_chunk(cfg, params, cache, tokens, slot, offsets,
                        block_tables, *, read_pages: int, lane_mask=None,
                        q_lens=None, dist=None):
    """Chunked prefill over the paged pool: the (B, C) chunk's K/V lands
    at logical slots from ``slot`` (an int, or a (B,) tensor of per-lane
    starts) through each lane's block table; ``q_lens`` (B,) makes the
    query runs ragged (the mixed decode+prefill batch). Attention reads
    each lane's first ``read_pages`` pages (must cover every start +
    C). Returns (logits (B,C,V) f32, cache), updated in place."""
    check_serving(cfg, dist)
    x = embed_inputs(cfg, params, tokens, dist=dist)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.paged_chunk_attention(
            cfg, p_a, h, ck, cv, block_tables, slot, offsets,
            read_pages=read_pages, window=window, lane_mask=lane_mask,
            q_lens=q_lens)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn, dist)
    return logits_from_hidden(cfg, params, x), cache
