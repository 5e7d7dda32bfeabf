"""Mixture-of-Experts layer, GShard-style top-k routing with a static
per-expert capacity (port of ``repro/models/moe.py``).

Every expert is computed at capacity C, whatever its load: slots past an
expert's token count are masked by ``valid``, as in the reference, so
every shape is static and no step reads the device from the host (the
capacity is a host integer of the static token count). Packed expert
weights carry a leading expert axis and go through the expert-batched
kernels of ``kernels/ops.py`` (one fused-GLU and one BSpMM launch for all
experts: the reference ``vmap``s the same call). The router, softmax,
top-k, capacity sort, gather and combine stay plain PyTorch, as they are
plain XLA in the reference.

The reference's combine is a scatter-add into a zero tensor of x's
dtype in (expert, slot) order. ``index_add_`` on CUDA adds with atomics
in no fixed order, so the combine here gathers, for each token, its
kept experts' rows in ascending expert order and adds them one at a time
in x's dtype: a token meets each expert at most once, so that is the
scatter's order for that token, and the streams repeat bitwise run to
run.

``CALLS`` counts the layer's calls by (tokens in the call, capacity C):
both are host integers of the static shapes, so counting reads nothing
from the device.

The expert-parallel path (``moe_forward(axis_name=dist)``, the
reference's ``_moe_shardmap`` over the model axis) runs each rank's E/tp
experts through the same expert-batched launches, with
``expert_offset`` naming their global ids; one reduction per layer sums
the ranks' partial outputs.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch.core import sparse_mlp as sm
from repro_torch.core.packing import PackedBCSC
from repro_torch.models.params import ParamSpec

CALLS: collections.Counter = collections.Counter()


def moe_param_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    down_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    specs = {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamSpec((e, f, d), ("experts", "ff", "embed"),
                            scale=down_scale),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        specs.update({
            "ws_gate": ParamSpec((d, fs), ("embed", None)),
            "ws_up": ParamSpec((d, fs), ("embed", None)),
            "ws_down": ParamSpec((fs, d), (None, "embed"), scale=down_scale),
        })
    return specs


def capacity(cfg, n_tokens: int) -> int:
    """Static per-expert capacity (GShard)."""
    c = math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                  / cfg.num_experts)
    return max(c, 1)


def route(cfg, x_flat: torch.Tensor, router: torch.Tensor):
    """-> (top_vals (T, k) f32 normalized, top_idx (T, k) int64, aux
    loss, a 0-d f32 tensor)."""
    logits = x_flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    e = cfg.num_experts
    hits = torch.nn.functional.one_hot(top_idx[:, 0], e).float()
    aux = e * torch.mean(hits.mean(0) * probs.mean(0)) * e
    return top_vals, top_idx, aux


def _n_experts(w) -> int:
    return w.idx.shape[0] if isinstance(w, PackedBCSC) else w.shape[0]


def local_expert_forward(cfg, x_flat, top_vals, top_idx, w_gate, w_up,
                         w_down, masks=None, expert_offset: int = 0):
    """The contribution of ``E_l`` experts (ids ``expert_offset`` + [0,
    E_l)) to every token. x_flat (T, D); w_* (E_l, D, F) / (E_l, F, D),
    or packs with a leading E_l; top_vals in x's dtype. Returns (T, D)."""
    t, d = x_flat.shape
    packed = isinstance(w_gate, PackedBCSC)
    e_l = _n_experts(w_gate)
    c = capacity(cfg, t)
    CALLS[(t, c)] += 1
    spec = cfg.blast
    if masks is not None and spec.enabled and not packed:
        w_gate = sm.apply_mask_ste(w_gate, masks["w_gate"], spec.b_in,
                                   spec.b_out)
        w_up = sm.apply_mask_ste(w_up, masks["w_up"], spec.b_in, spec.b_out)
        w_down = sm.apply_mask_ste(w_down, masks["w_down"], spec.b_out,
                                   spec.b_in)

    dev = x_flat.device
    local_ids = expert_offset + torch.arange(e_l, device=dev)
    onehot = top_idx[:, :, None] == local_ids              # (T, k, E_l)
    gate = (top_vals[:, :, None] * onehot).sum(1)          # (T, E_l)
    hit = onehot.any(1)                                    # (T, E_l)
    # per-expert token lists: kept tokens first (a stable sort of ~hit,
    # on integers), capped at capacity; [:c] keeps T rows when c > T
    order = torch.argsort((~hit).to(torch.int32), dim=0, stable=True)[:c]
    valid = torch.gather(hit, 0, order)                    # (C, E_l)
    idx = torch.where(valid, order, 0).T.contiguous()      # (E_l, C)
    valid = valid.T

    xe = x_flat[idx]                              # (E_l, C, D), contiguous
    if packed:
        from repro_torch.kernels import ops
        ye = ops.sparse_mlp_apply(xe, w_gate, w_up, w_down, act=cfg.mlp_act)
    else:
        dt = xe.dtype
        h = sm.act_fn(cfg.mlp_act)(
            torch.einsum("ecd,edf->ecf", xe, w_gate.to(dt))
        ) * torch.einsum("ecd,edf->ecf", xe, w_up.to(dt))
        ye = torch.einsum("ecf,efd->ecd", h, w_down.to(dt))
    gate_ec = torch.gather(gate.T, 1, idx)                 # (E_l, C)
    ye = ye * (gate_ec * valid)[..., None].to(ye.dtype)
    return _combine(x_flat, ye, top_idx, hit, expert_offset)


def _combine(x_flat, ye, top_idx, hit, expert_offset):
    """out[t] = the sum of ye[e, slot of t] over t's kept local experts,
    added in ascending e from zero in x's dtype: the reference's
    scatter-add order. A token's slot in expert e's list is its rank
    among e's hits (the stable sort keeps token order); a rank past the
    capacity, or an expert outside this shard, adds nothing."""
    e_l, c, d = ye.shape
    rank = torch.cumsum(hit.to(torch.int32), dim=0) - 1    # (T, E_l)
    ids = torch.sort(top_idx, dim=1).values - expert_offset  # (T, k)
    local = (ids >= 0) & (ids < e_l)
    ids = ids.clamp(0, e_l - 1)
    slot = torch.gather(rank, 1, ids)                      # (T, k)
    kept = local & (slot < c)
    flat = ids * c + slot.clamp(0, c - 1)
    rows = ye.reshape(e_l * c, d)
    out = torch.zeros_like(x_flat)
    zero = torch.zeros((), dtype=x_flat.dtype, device=x_flat.device)
    for j in range(ids.shape[1]):
        out = out + torch.where(kept[:, j, None], rows[flat[:, j]], zero)
    return out


def shared_expert_forward(cfg, x, p, masks=None):
    """Replicated shared experts (deepseek): a plain GLU MLP."""
    mm = None
    if masks is not None and cfg.blast.enabled:
        mm = {"w_gate": masks.get("ws_gate"), "w_up": masks.get("ws_up"),
              "w_down": masks.get("ws_down")}
    return sm.glu_mlp(x, p["ws_gate"], p["ws_up"], p["ws_down"],
                      act=cfg.mlp_act, masks=mm, spec=cfg.blast)


def moe_forward(cfg, p, x, masks=None, axis_name=None, seq: bool = False):
    """Full MoE layer. x (B, S, D) -> ((B, S, D), aux loss).

    ``axis_name``: None on one device (every expert local); else the
    ``DistContext`` of the expert-parallel path (the reference calls it
    with the model axis's name inside ``_moe_shardmap``): ``p``'s expert
    stacks (and ``masks``) are this rank's slice ``DistContext.
    expert_range``, the router and the shared experts are whole. The
    tokens are whole on every rank (``to_parallel``: the identity, or
    with ``seq`` the gather of the S shards), each rank routes them all
    and computes its experts' contribution at the capacity of the whole
    call's tokens, and the partial outputs are summed over the model axis
    in one reduction (``from_parallel``: an all-reduce, or with ``seq`` a
    reduce-scatter to this rank's S shard). The shared experts are added
    after it, on the stream as it came in (replicated, or the S shard),
    so their input gradient is never summed over the model axis. The aux
    loss is whole on every rank; ``count_once`` passes 1/tp of its
    gradient back, as the model axis sums the router's gradient and the
    input's."""
    dist = axis_name
    if dist is not None and not hasattr(dist, "expert_range"):
        raise TypeError("axis_name takes the DistContext of the "
                        f"expert-parallel path, not {dist!r}")
    x_in = x
    if dist is not None:
        x = dist.to_parallel(x, True, seq)
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    top_vals, top_idx, aux = route(cfg, x_flat, p["router"])
    off = 0
    if dist is not None:
        off, e_l = dist.expert_range(cfg.num_experts)
        if _n_experts(p["w_gate"]) != e_l:
            raise ValueError(
                f"rank {dist.model_rank} holds {_n_experts(p['w_gate'])} "
                f"experts, expected its {e_l} of {cfg.num_experts}")
    y = local_expert_forward(cfg, x_flat, top_vals.to(x.dtype), top_idx,
                             p["w_gate"], p["w_up"], p["w_down"],
                             masks=masks, expert_offset=off)
    y = y.reshape(b, s, d)
    if dist is not None:
        y = dist.from_parallel(y, True, seq)
        aux = dist.count_once(aux)
    if cfg.num_shared_experts:
        y = y + shared_expert_forward(cfg, x_in, p, masks)
    return y, aux
