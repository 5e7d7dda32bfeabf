"""Model registry (port of ``repro/models/registry.py``): family ->
implementation module and the generic entry points the training loop
and the serving path call. Only the dense transformer family is
ported."""
from __future__ import annotations

import math

from repro_torch.models import params as pmod
from repro_torch.models import transformer


def module_for(cfg):
    if cfg.family == "dense":
        return transformer
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def param_specs(cfg):
    return module_for(cfg).param_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    """Seeded f32 parameters on ``device``."""
    return pmod.init_params(param_specs(cfg), seed, device)


def sparse_paths(cfg):
    return module_for(cfg).sparse_paths(cfg)


def dense_layer_flags(cfg):
    return module_for(cfg).dense_layer_flags(cfg)


def forward(cfg, params, tokens, **kw):
    """Training forward -> (logits (B,S,V) f32, aux loss)."""
    return module_for(cfg).forward(cfg, params, tokens, **kw)


def count_params(cfg) -> int:
    """Parameter count from the spec tree (no allocation)."""
    return sum(math.prod(s.shape) for _, s in pmod._leaves(param_specs(cfg)))


def init_masks(cfg, params):
    """BLaST mask tree for this model (all-kept at init)."""
    from repro_torch.core import sparse_mlp as sm
    if not cfg.blast.enabled:
        return {}
    return sm.init_masks(cfg.blast, params, sparse_paths(cfg))


def supports_paged(cfg) -> bool:
    """Paged KV pool + block-table attention."""
    return cfg.family == "dense"


def init_paged_cache(cfg, n_pages, page_size, **kw):
    return module_for(cfg).init_paged_cache(cfg, n_pages, page_size, **kw)


def paged_decode_step(cfg, params, cache, tokens, pos, block_tables, *,
                      read_pages, **kw):
    return module_for(cfg).paged_decode_step(
        cfg, params, cache, tokens, pos, block_tables,
        read_pages=read_pages, **kw)


def paged_prefill_chunk(cfg, params, cache, tokens, slot, offsets,
                        block_tables, *, read_pages, **kw):
    return module_for(cfg).paged_prefill_chunk(
        cfg, params, cache, tokens, slot, offsets, block_tables,
        read_pages=read_pages, **kw)
