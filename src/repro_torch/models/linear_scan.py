"""Chunked linear attention with per-channel (RWKV6) or per-head scalar
(Mamba2/SSD) decay, the token mixer of the ``ssm`` and ``hybrid``
families (port of ``repro/models/linear_scan.py``).

Recurrence (per head, state S in R^{dk x dv}):

    S_t = Diag(w_t) S_{t-1} + k_t^T v_t
    y_t = q_t S_{t-1} + (q_t ⊙ u) k_t^T v_t      (include_diag='bonus', RWKV)
    y_t = q_t S_t                                 (include_diag='full', SSD)

Chunked evaluation (chunk C): intra-chunk attention with decay weights
plus an inter-chunk state carry, and an exact O(1) recurrent step for
decode. Everything is computed in f32 from inputs cast to f32, and the
outputs are cast back to the input dtype, as in the reference; the
reference's ``lax.scan`` over chunks is a Python loop carrying the f32
state.

The factorized intra-chunk form q·exp(Λ_t−mid) × k·exp(mid−Λ_s) is exact
only while the centred exponents stay in f32 range, so the per-step
log-decay is floored at ``-RANGE/chunk``. The chunked path floors at
``min(chunk, S)`` and the recurrent step at ``chunk``: a forward shorter
than one chunk floors differently from decode, exactly as the reference
does.
"""
from __future__ import annotations

import torch

RANGE = 70.0


def decay_floor(chunk: int) -> float:
    return -RANGE / max(chunk, 1)


def _chunk(x: torch.Tensor, c: int) -> torch.Tensor:
    b, s = x.shape[:2]
    return x.reshape(b, s // c, c, *x.shape[2:])


def _chunk_len(chunk: int, s: int) -> int:
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {c}")
    return c


def chunked_linear_attention(q, k, v, log_w, *, u=None, chunk=64,
                             initial_state=None, include_diag="full"):
    """q, k (B,S,H,dk); v (B,S,H,dv); log_w (B,S,H,dk) (<= 0; per-head
    scalar decays broadcast to dk); u (H,dk) bonus or None.

    Returns (y (B,S,H,dv) in q's dtype, final_state (B,H,dk,dv) f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = _chunk_len(chunk, s)
    log_w = torch.clamp(log_w.float(), min=decay_floor(c))
    qc, kc, vc, wc = (_chunk(t, c) for t in (q, k, v, log_w))
    lam = torch.cumsum(wc, dim=2)                         # (B,N,C,H,dk)
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device),
                     0 if include_diag == "full" else -1)
    uf = None if u is None else u.float()
    ys = []
    for n in range(s // c):
        q_c, k_c, v_c = qc[:, n].float(), kc[:, n].float(), vc[:, n].float()
        lam_c, w_c = lam[:, n], wc[:, n]
        # decay of q_t relative to the chunk start: 'bonus' reads S_{t-1}
        # (Λ_t − w_t), 'full' reads S_t (Λ_t)
        lam_q = lam_c - w_c if include_diag == "bonus" else lam_c
        y = torch.einsum("bchk,bhkv->bchv", q_c * torch.exp(lam_q), state)
        # intra-chunk, mid-centred: |Λ − mid| <= RANGE/2 by the floor
        mid = lam_c[:, c // 2, None]
        qf = q_c * torch.exp(lam_q - mid)
        kf = k_c * torch.exp(mid - lam_c)
        a = torch.einsum("bthk,bshk->bhts", qf, kf)
        a = torch.where(tri[None, None], a, 0.0)
        y = y + torch.einsum("bhts,bshv->bthv", a, v_c)
        if uf is not None:   # RWKV bonus: the current token through u
            diag = torch.einsum("bthk,hk,bthk->bth", q_c, uf, k_c)
            y = y + diag[..., None] * v_c
        # S1 = Diag(exp(Λ_C)) S0 + Σ_s Diag(exp(Λ_C − Λ_s)) k_sᵀ v_s
        lam_end = lam_c[:, -1]
        k_out = k_c * torch.exp(lam_end[:, None] - lam_c)
        state = (torch.exp(lam_end)[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_out, v_c))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, dv)
    return y.to(q.dtype), state


def chunked_ssd(q, k, v, log_a, *, chunk=64, initial_state=None):
    """Grouped SSD (Mamba2, n_groups=1): q, k shared across heads, a
    scalar decay per head. q, k (B,S,ds); v (B,S,H,hd); log_a (B,S,H)
    (<= 0). The decay matrices are built directly with exponents
    Λ_t − Λ_s <= 0, so there is no floor.

    Returns (y (B,S,H,hd) in v's dtype, state (B,H,ds,hd) f32)."""
    b, s, ds = q.shape
    h, hd = v.shape[2], v.shape[3]
    c = _chunk_len(chunk, s)
    qc, kc, vc, ac = (_chunk(t, c) for t in (q, k, v, log_a.float()))
    lam = torch.cumsum(ac, dim=2)                         # (B,N,C,H)
    state = (torch.zeros((b, h, ds, hd), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for n in range(s // c):
        q_c, k_c, v_c = qc[:, n].float(), kc[:, n].float(), vc[:, n].float()
        lam_c = lam[:, n]
        # inter-chunk: y[b,t,h,v] = exp(Λ_t^h) Σ_d q_td S0[h,d,v]
        y = (torch.einsum("btd,bhdv->bthv", q_c, state)
             * torch.exp(lam_c)[..., None])
        # intra-chunk: A0 shared across heads, a decay matrix per head
        a0 = torch.einsum("btd,bsd->bts", q_c, k_c)       # (B,C,C)
        dec = torch.exp(lam_c[:, :, None] - lam_c[:, None, :, :])
        a = a0[..., None] * torch.where(tri[None, :, :, None], dec, 0.0)
        y = y + torch.einsum("btsh,bshv->bthv", a, v_c)
        # S1 = exp(Λ_C) S0 + Σ_s k_s ⊗ (v_s exp(Λ_C − Λ_s))
        lam_end = lam_c[:, -1]                            # (B,H)
        vdec = v_c * torch.exp(lam_end[:, None] - lam_c)[..., None]
        state = (torch.exp(lam_end)[..., None, None] * state
                 + torch.einsum("bsd,bshv->bhdv", k_c, vdec))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)
    return y.to(v.dtype), state


def ssd_recurrent_step(q, k, v, log_a, state, *, chunk=64):
    """Grouped-SSD decode step. q, k (B,ds); v (B,H,hd); log_a (B,H);
    state (B,H,ds,hd) f32. Returns (y (B,H,hd) in v's dtype, state)."""
    a = torch.exp(log_a.float())
    kv = k.float()[:, None, :, None] * v.float()[:, :, None, :]
    new_state = a[..., None, None] * state + kv
    y = torch.einsum("bd,bhdv->bhv", q.float(), new_state)
    return y.to(v.dtype), new_state


def recurrent_step(q, k, v, log_w, state, *, u=None, chunk=64,
                   include_diag="full"):
    """Exact single-token recurrence for decode, floored as the chunked
    path of a ``chunk``-long chunk. q, k (B,H,dk); v (B,H,dv); log_w
    (B,H,dk); state (B,H,dk,dv) f32. Returns (y (B,H,dv) in q's dtype,
    new_state)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(torch.clamp(log_w.float(),
                              min=decay_floor(min(chunk, 1 << 30))))
    kv = kf[..., :, None] * vf[..., None, :]              # (B,H,dk,dv)
    new_state = w[..., None] * state + kv
    if include_diag == "bonus":
        y = torch.einsum("bhk,bhkv->bhv", qf, state)
        y = y + torch.einsum("bhk,hk,bhkv->bhv", qf, u.float(), kv)
    else:
        y = torch.einsum("bhk,bhkv->bhv", qf, new_state)
    return y.to(q.dtype), new_state
