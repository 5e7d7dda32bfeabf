"""Gradient compression for the data-parallel reduction (port of
``repro/optim/compress.py``).

  * **int8 error-feedback quantization**: per leaf, ``g + err`` is
    quantized to int8 at scale ``max|g + err| / 127`` and the residual is
    carried in the error-feedback buffer, so the compression is unbiased
    over time (SGD-EF);
  * **traffic_report**: the bytes a data rank puts on the wire per step,
    f32 against int8 against int8 of the kept BLaST blocks.

The reduction (``reduce_leaf_int8``) differs from the reference's in one
place, a fault the port does not copy: the reference quantizes each rank
at its own scale ``s_r``, sums the int8 payloads and multiplies the sum
by ``max_r s_r``, which is biased whenever the scales differ (ranks with
gradients [1.0] and [0.01] both send 127; the "mean" is 1.0, not 0.505,
and the second rank's residual is 0, so the bias never decays). Here one
scalar all-reduce takes the maximum of the ranks' scales first and every
rank quantizes at that shared scale: each rank's error is then at most
half a step, and so is the mean's. With one rank the two agree bitwise.

On the wire: the scale's all-reduce (4 bytes a leaf), then an
all-gather of the int8 payloads (1 byte an element from each rank),
summed in int32 on every rank: the same sum as the reference's ``psum``
of int32, which moves 4 bytes an element where its report says 1.

The residual ``g + err - q * scale`` is rounded once, as the reference's
jitted step computes it (XLA fuses the product into the subtraction):
the product and the difference are exact in f64, so a chunked f64
evaluation gives the fused result on any device.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def quantize_int8(g: torch.Tensor, err: torch.Tensor,
                  scale: torch.Tensor | None = None):
    """-> (q int8, scale f32 scalar, new_err). ``g + err`` is quantized,
    at ``max|g + err| / 127`` unless a (shared) ``scale`` is given."""
    gf = g.float() + err
    if scale is None:
        scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, _residual(gf, q, scale)


def _residual(gf, q, scale, chunk: int = 1 << 24):
    """gf - q * scale rounded once (a fused multiply-subtract), in f64
    chunks of ``chunk`` elements."""
    out = torch.empty_like(gf)
    src, qs, dst = gf.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for a in range(0, src.numel(), chunk):
        b = a + chunk
        dst[a:b] = (src[a:b].double() - qs[a:b].double() * s).float()
    return out


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def reduce_leaf_int8(g: torch.Tensor, e: torch.Tensor, dist):
    """One leaf's compressed mean over the data axes of ``dist`` (None or
    one data rank: this rank alone) -> (mean f32, new error feedback):
    the shared scale (a max all-reduce of one scalar), the int8 payload
    all-gathered and summed in int32."""
    gf = g.float() + e
    s = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    n = 1 if dist is None else dist.data_size
    if n > 1:
        s = dist.max_over_data(s.clone())
    q, s, ne = quantize_int8(g, e, s)
    if n > 1:
        total = torch.stack(dist.gather_over_data(q)).to(torch.int32).sum(0)
    else:
        total = q.to(torch.int32)
    return total.float() * s / n, ne


def compressed_psum(grads, err, dist):
    """Mean of ``grads`` over the data axes with int8 EF compression ->
    (mean grads f32, new err), leaf by leaf."""
    out = tree_map(lambda g, e: reduce_leaf_int8(g, e, dist), grads, err)
    return (tree_map(lambda o: o[0], out),
            tree_map(lambda o: o[1], out))


def traffic_report(grads, masks=None, spec=None, sparsity: float = 0.0
                   ) -> dict:
    """Bytes a data rank sends per step: f32 against int8 against int8 of
    the kept blocks (the reference's keys and numbers), plus what the
    port's reduction adds: ``scale_bytes``, one f32 scale a leaf."""
    leaves = tree_leaves(grads)
    total = sum(g.numel() for g in leaves)
    sparse_frac = 1.0
    if masks:
        from repro_torch.core import sparse_mlp as sm
        sparse_elems = 0
        kept = 0
        for path, m in masks.items():
            g = sm.get_path(grads, path)
            sparse_elems += g.numel()
            kept += float(m.float().mean()) * g.numel()
        sparse_frac = (total - sparse_elems + kept) / total
    return {
        "f32_bytes": 4 * total,
        "int8_bytes": total,
        "int8_sparse_bytes": int(total * sparse_frac),
        "reduction_vs_f32": 4 / sparse_frac,
        "scale_bytes": 4 * len(leaves),
    }
