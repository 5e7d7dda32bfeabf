"""Decoder-only transformer LM, dense family (port of the dense part of
``repro/models/transformer.py``): the training forward and the paged
serving steps.

Params are nested dicts whose layer leaves are stacked on a leading
layer axis, exactly as in the reference; the reference's ``lax.scan``
over that axis becomes a Python loop over per-layer views, and BLaST
masks ride along as per-layer views of the stacked mask tree.
gemma2-style ``local_global`` stacks run as (local, global) pairs. With
``cfg.remat`` each layer of the training forward is recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
with nothing saved): this changes memory, not numbers. The KV pool is
updated in place (models/attention.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.core import sparse_mlp as sm
from repro_torch.core.packing import PackedBCSC
from repro_torch.models import attention as attn
from repro_torch.models.layers import norm, softcap
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
        raise NotImplementedError("MoE is not ported yet")
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


def sparse_paths(cfg) -> list[str]:
    """Param-tree paths of the BLaST-sparsified (stacked) weights."""
    stacks = (["layers_local", "layers_global"]
              if cfg.layer_pattern == "local_global" else ["layers"])
    leaves = (["mlp/w_gate", "mlp/w_up", "mlp/w_down"]
              if cfg.mlp_kind == "glu" else ["mlp/w_in", "mlp/w_out"])
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
    cols = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
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


def mlp_forward(cfg, p, x, masks=None):
    if cfg.mlp_kind == "glu":
        return sm.glu_mlp(x, p["w_gate"], p["w_up"], p["w_down"],
                          act=cfg.mlp_act, masks=masks, spec=cfg.blast)
    return sm.mlp2(x, p["w_in"], p["w_out"], p.get("b_in"), p.get("b_out"),
                   act=cfg.mlp_act, masks=masks, spec=cfg.blast)


def _block(cfg, p, x, positions, masks, window):
    """One pre-norm transformer block (full causal attention)."""
    h = norm(cfg.norm_kind, x, p["ln_attn_scale"], p.get("ln_attn_bias"))
    x = x + attn.multihead_attention(cfg, p["attn"], h, positions,
                                     causal=True, window=window)[0]
    h = norm(cfg.norm_kind, x, p["ln_mlp_scale"], p.get("ln_mlp_bias"))
    return x + mlp_forward(cfg, p["mlp"], h, masks)


def forward(cfg, params, tokens, *, masks=None):
    """Training/prefill forward: tokens (B,S) int -> (logits (B,S,V) f32,
    aux loss). ``masks`` is the BLaST mask tree (None: dense)."""
    b, s = tokens.shape
    x = embed_inputs(cfg, params, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(p_l, m_l, x, window):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                _block, cfg, p_l, x, positions, m_l, window,
                use_reentrant=False)
        return _block(cfg, p_l, x, positions, m_l, window)

    if cfg.layer_pattern == "local_global":
        loc = _unbind(params["layers_local"])
        glb = _unbind(params["layers_global"])
        m_loc = _unbind(_layer_masks(masks, "layers_local"), len(loc))
        m_glb = _unbind(_layer_masks(masks, "layers_global"), len(glb))
        for p_l, m_l, p_g, m_g in zip(loc, m_loc, glb, m_glb):
            x = layer(p_l, m_l, x, cfg.sliding_window)
            x = layer(p_g, m_g, x, 0)
    else:
        lay = _unbind(params["layers"])
        for p_l, m_l in zip(lay, _unbind(_layer_masks(masks, "layers"),
                                         len(lay))):
            x = layer(p_l, m_l, x, cfg.sliding_window)
    return logits_from_hidden(cfg, params, x), 0.0


def embed_inputs(cfg, params, tokens):
    x = params["embed"][tokens.long()].to(DTYPES[cfg.compute_dtype])
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def logits_from_hidden(cfg, params, x):
    """Final norm + (tied) LM head -> f32 logits."""
    xf = norm(cfg.norm_kind, x, params["ln_f_scale"], params.get("ln_f_bias"))
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = xf @ head.to(xf.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Paged KV pool (layers, n_pages, page_size, KV, hd), SHARED by every
    lane; a pool page is allocated across all layers at once, so block
    tables are layer-independent."""
    ns, per = n_stacks(cfg)
    _, kv = attn.eff_heads(cfg)
    shape = (ns * per, n_pages, page_size, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _run_stack(cfg, params, cache, x, attn_fn):
    """Run every layer with a pluggable attention core
    ``attn_fn(p_attn, h, ck, cv, window) -> out`` that reads and writes
    this layer's cache views ``ck``/``cv`` in place. Returns hidden."""
    def one(window, p_l, x, li):
        h = norm(cfg.norm_kind, x, p_l["ln_attn_scale"],
                 p_l.get("ln_attn_bias"))
        x = x + attn_fn(p_l["attn"], h, cache["k"][li], cache["v"][li],
                        window)
        h = norm(cfg.norm_kind, x, p_l["ln_mlp_scale"],
                 p_l.get("ln_mlp_bias"))
        return x + mlp_forward(cfg, p_l["mlp"], h)

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


def paged_decode_step(cfg, params, cache, tokens, pos, block_tables, *,
                      read_pages: int, offsets=None):
    """One decode step over the paged pool. tokens (B,1); pos (B,) logical
    cache slots (parked lanes carry ``max_pages * page_size``: the write
    drops); block_tables (B, max_pages) int32; attention reads each
    lane's first ``read_pages`` pages. Returns (logits (B,1,V) f32,
    cache), the cache updated in place."""
    x = embed_inputs(cfg, params, tokens)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.paged_decode_attention(
            cfg, p_a, h, ck, cv, block_tables, pos, read_pages=read_pages,
            window=window, offsets=offsets)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn)
    return logits_from_hidden(cfg, params, x), cache


def paged_prefill_chunk(cfg, params, cache, tokens, slot, offsets,
                        block_tables, *, read_pages: int, lane_mask=None):
    """Chunked prefill over the paged pool: the (B, C) chunk's K/V lands
    at logical slots [slot, slot+C) through each lane's block table;
    attention reads each lane's first ``read_pages`` pages (must cover
    slot+C). Returns (logits (B,C,V) f32, cache), updated in place."""
    x = embed_inputs(cfg, params, tokens)

    def attn_fn(p_a, h, ck, cv, window):
        return attn.paged_chunk_attention(
            cfg, p_a, h, ck, cv, block_tables, slot, offsets,
            read_pages=read_pages, window=window, lane_mask=lane_mask)[0]

    x = _run_stack(cfg, params, cache, x, attn_fn)
    return logits_from_hidden(cfg, params, x), cache
