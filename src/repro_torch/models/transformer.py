"""Decoder-only transformer LM, dense family (port of the dense, paged
part of ``repro/models/transformer.py``).

Params are nested dicts whose layer leaves are stacked on a leading
layer axis, exactly as in the reference; the reference's ``lax.scan``
over that axis becomes a Python loop over per-layer views. gemma2-style
``local_global`` stacks run as (local, global) pairs. The KV pool is
updated in place (models/attention.py).
"""
from __future__ import annotations

import math
from typing import Any

import torch

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
                ParamSpec((n,) + v.shape, ("layers",) + v.axes,
                          init=v.init, scale=v.scale, dtype=v.dtype))
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


# ----------------------------------------------------------------- forward
def _layer_view(tree, i: int):
    """Entry ``i`` of the leading layer axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return tree.layer(i)
    return tree[i]


def mlp_forward(cfg, p, x):
    if cfg.mlp_kind == "glu":
        return sm.glu_mlp(x, p["w_gate"], p["w_up"], p["w_down"],
                          act=cfg.mlp_act)
    return sm.mlp2(x, p["w_in"], p["w_out"], p.get("b_in"), p.get("b_out"),
                   act=cfg.mlp_act)


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
