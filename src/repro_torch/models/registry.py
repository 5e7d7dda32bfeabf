"""Model registry (port of ``repro/models/registry.py``): family ->
implementation module and the generic entry points the training loop and
the serving path call. The dense, MoE and ``vlm`` families run
``models/transformer.py``, ``ssm`` runs ``models/rwkv6.py``, ``hybrid``
``models/zamba.py`` and ``audio`` ``models/whisper.py``. The entry
points take ``dist=`` (tensor-parallel serving and the sharded train
step, every family) and hand it on only when it is set. A decode cache
made under ``dist`` holds the rank's heads and the rows of its data
group (``DistContext.batch_rows``, as the reference's
``cache_sharding`` splits the batch)."""
from __future__ import annotations

import math

from repro_torch.models import params as pmod
from repro_torch.models import rwkv6, transformer, whisper, zamba

_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": rwkv6, "hybrid": zamba, "audio": whisper}


def module_for(cfg):
    return _MODULES[cfg.family]


def param_specs(cfg):
    return module_for(cfg).param_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    """Seeded f32 parameters on ``device``; the heads that
    ``pad_heads_to`` adds start at zero (each module's
    ``zero_padded_heads``)."""
    mod = module_for(cfg)
    params = pmod.init_params(mod.param_specs(cfg), seed, device)
    mod.zero_padded_heads(cfg, params)
    return params


def abstract_params(cfg):
    """Shapes and dtypes of the parameter tree (no allocation)."""
    return pmod.abstract_params(param_specs(cfg))


def axes_tree(cfg):
    """Logical axis names of every leaf, parallel to the params tree."""
    return pmod.axes_tree(param_specs(cfg))


def sparse_paths(cfg):
    return module_for(cfg).sparse_paths(cfg)


def dense_layer_flags(cfg):
    return module_for(cfg).dense_layer_flags(cfg)


def _dist_kw(kw: dict, dist) -> dict:
    return kw if dist is None else dict(kw, dist=dist)


def forward(cfg, params, tokens, *, dist=None, **kw):
    """Training forward -> (logits (B,S,V) f32, aux loss)."""
    return module_for(cfg).forward(cfg, params, tokens, **_dist_kw(kw, dist))


def count_params(cfg, active_only: bool = False) -> int:
    """Parameter count from the spec tree (no allocation). With
    ``active_only`` an expert stack counts only its top_k experts (the
    N_active of 6·N_active·D); a dense model has none, so both counts
    agree there."""
    total = 0
    for _, s in pmod._leaves(param_specs(cfg)):
        n = math.prod(s.shape)
        if active_only and "experts" in s.axes:
            n = n // cfg.num_experts * cfg.top_k
        total += n
    return total


def init_masks(cfg, params):
    """BLaST mask tree for this model (all-kept at init)."""
    from repro_torch.core import sparse_mlp as sm
    if not cfg.blast.enabled:
        return {}
    return sm.init_masks(cfg.blast, params, sparse_paths(cfg))


def _rows(batch, dist):
    return batch if dist is None else dist.batch_rows(batch)[1]


def init_cache(cfg, batch, max_len, *, dist=None, **kw):
    """The decode cache of ``serve_loop`` (``dtype``, ``device``): the
    contiguous KV cache (layers, batch, max_len, KV, hd) of a transformer,
    the recurrent state of the ``ssm`` and ``hybrid`` families, and
    whisper's self-attention cache (its encoder memory is
    ``whisper.prefill_cross``'s); under ``dist`` the rank's heads and its
    data group's rows of ``batch``."""
    return module_for(cfg).init_cache(cfg, _rows(batch, dist), max_len,
                                      **_dist_kw(kw, dist))


def abstract_cache(cfg, batch, max_len, *, dist=None, **kw):
    """Shapes and dtypes of the decode cache (no allocation): a
    transformer's KV cache, the recurrent families' state, whisper's
    self-attention cache with its encoder memory (the rank's kv heads and
    its data group's rows of ``batch`` under ``dist``)."""
    return module_for(cfg).abstract_cache(cfg, _rows(batch, dist), max_len,
                                          **_dist_kw(kw, dist))


def decode_step(cfg, params, cache, tokens, pos, *, dist=None, **kw):
    """One decode step over the contiguous cache; ``pos`` an int
    (synchronized batch) or a (B,) tensor (per-lane frontiers)."""
    return module_for(cfg).decode_step(cfg, params, cache, tokens, pos,
                                       **_dist_kw(kw, dist))


def supports_prefill_chunk(cfg) -> bool:
    return hasattr(module_for(cfg), "prefill_chunk")


def prefill_chunk(cfg, params, cache, tokens, slot, offsets, *, dist=None,
                  **kw):
    """Batched chunked prefill over the contiguous cache."""
    mod = module_for(cfg)
    if not hasattr(mod, "prefill_chunk"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no chunked prefill; use "
            "serve_loop.prefill_with_decode")
    return mod.prefill_chunk(cfg, params, cache, tokens, slot, offsets,
                             **_dist_kw(kw, dist))


def supports_paged(cfg) -> bool:
    """Paged KV pool + block-table attention."""
    return hasattr(module_for(cfg), "paged_decode_step")


def supports_mixed(cfg) -> bool:
    """Mixed decode+prefill batches (per-lane starts and ``q_lens`` on
    the paged chunk path, so paged support implies it)."""
    return supports_paged(cfg)


def init_paged_cache(cfg, n_pages, page_size, *, dist=None, **kw):
    return module_for(cfg).init_paged_cache(cfg, n_pages, page_size,
                                            **_dist_kw(kw, dist))


def paged_decode_step(cfg, params, cache, tokens, pos, block_tables, *,
                      read_pages, dist=None, **kw):
    return module_for(cfg).paged_decode_step(
        cfg, params, cache, tokens, pos, block_tables,
        read_pages=read_pages, **_dist_kw(kw, dist))


def paged_prefill_chunk(cfg, params, cache, tokens, slot, offsets,
                        block_tables, *, read_pages, dist=None, **kw):
    return module_for(cfg).paged_prefill_chunk(
        cfg, params, cache, tokens, slot, offsets, block_tables,
        read_pages=read_pages, **_dist_kw(kw, dist))
