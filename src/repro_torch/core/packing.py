"""Packed balanced-BCSC representation for serving (port of
``repro/core/packing.py``).

A sparse weight W (K, N) whose block mask keeps the same number ``nnz``
of (b_in, b_out) blocks in every block-column is stored as

    blocks : (..., Nb, nnz, b_in, b_out)   kept block values, column-major
    idx    : (..., Nb, nnz) int32          block-row index of each block

Unbalanced masks are padded with zero blocks at idx 0 (exact). ``kb``,
``joint`` and ``partial`` are plain attributes: ``joint`` promises that
this operand's idx table equals its fused-GLU partner's, so the joint
kernel may load each X tile once for both products; ``partial`` marks one
rank's share of a tensor-parallel pack whose kept blocks (the nnz dim)
were split over the model axis, so its product is a partial sum that the
ranks all-reduce (``serving/export.py::shard_params``). The kernels read
neither flag's meaning from anything but the tables they are given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PackedBCSC:
    blocks: torch.Tensor   # (..., Nb, nnz, b_in, b_out)
    idx: torch.Tensor      # (..., Nb, nnz) int32
    kb: int                # number of block-rows
    joint: bool = False
    partial: bool = False  # a share of the kept blocks: a partial sum

    @property
    def nnz(self) -> int:
        return self.idx.shape[-1]

    @property
    def nb(self) -> int:
        return self.idx.shape[-2]

    @property
    def b_in(self) -> int:
        return self.blocks.shape[-2]

    @property
    def b_out(self) -> int:
        return self.blocks.shape[-1]

    def dense_shape(self) -> tuple[int, int]:
        return (self.kb * self.b_in, self.nb * self.b_out)

    def layer(self, i: int) -> "PackedBCSC":
        """Views of one entry of the leading (layer) axis."""
        return dataclasses.replace(self, blocks=self.blocks[i],
                                   idx=self.idx[i])


def mark_joint(p_gate: PackedBCSC, p_up: PackedBCSC
               ) -> tuple[PackedBCSC, PackedBCSC]:
    """Mark both operands ``joint`` when they share one idx table; no-op
    when the structures differ."""
    if (p_gate.idx.shape == p_up.idx.shape
            and torch.equal(p_gate.idx, p_up.idx)):
        return (dataclasses.replace(p_gate, joint=True),
                dataclasses.replace(p_up, joint=True))
    return p_gate, p_up


def max_nnz_per_col(block_mask: torch.Tensor) -> int:
    return int(block_mask.sum(dim=-2).max())


def pack(w: torch.Tensor, block_mask: torch.Tensor, b_in: int, b_out: int,
         nnz: int | None = None) -> PackedBCSC:
    """Pack a masked weight (..., K, N) with block mask (..., Kb, Nb) into
    balanced BCSC; leading axes (layers, experts) pack independently, in
    one pass. ``nnz`` defaults to the max per-column count."""
    *lead, k, n = w.shape
    kb, nb = k // b_in, n // b_out
    if tuple(block_mask.shape) != (*lead, kb, nb):
        raise ValueError(f"mask {tuple(block_mask.shape)} != grid "
                         f"{(*lead, kb, nb)}")
    if nnz is None:
        nnz = max_nnz_per_col(block_mask)
    m = block_mask.reshape(-1, kb, nb)                     # (L, Kb, Nb)
    # kept blocks of each column first, in block-row order; the stable
    # sort fixes the idx order the reference produces
    keyed = torch.where(m, 0, 1)
    order = torch.argsort(keyed, dim=1, stable=True)       # (L, Kb, Nb)
    sel = order[:, :nnz].transpose(1, 2).to(torch.int32)   # (L, Nb, nnz)
    valid = torch.gather(m.transpose(1, 2), 2, sel.long())  # (L, Nb, nnz)
    idx = torch.where(valid, sel, torch.zeros_like(sel))
    wb = w.reshape(-1, kb, b_in, nb, b_out).permute(0, 3, 1, 2, 4)
    dev = w.device
    blocks = wb[torch.arange(wb.shape[0], device=dev)[:, None, None],
                torch.arange(nb, device=dev)[None, :, None], idx.long()]
    blocks = torch.where(valid[..., None, None], blocks,
                         torch.zeros((), dtype=w.dtype, device=dev))
    return PackedBCSC(
        blocks=blocks.reshape(*lead, nb, nnz, b_in, b_out).contiguous(),
        idx=idx.reshape(*lead, nb, nnz).contiguous(), kb=kb)


def unpack(p: PackedBCSC) -> torch.Tensor:
    """Packed (one matrix) -> dense (K, N). Padding blocks are zero, so
    adding them at duplicate idx 0 is exact."""
    nb, nnz, b_in, b_out = p.blocks.shape
    dense = torch.zeros((nb, p.kb, b_in, b_out), dtype=p.blocks.dtype,
                        device=p.blocks.device)
    cols = torch.arange(nb, device=p.blocks.device)[:, None].expand(nb, nnz)
    dense.index_put_((cols, p.idx.long()), p.blocks, accumulate=True)
    return dense.permute(1, 2, 0, 3).reshape(p.kb * b_in, nb * b_out)


def pad_nnz(p: PackedBCSC, nnz: int) -> PackedBCSC:
    """Pad the per-column block count with zero blocks at idx 0 (exact).
    Padding edits the idx table, so it drops any ``joint`` promise."""
    cur = p.idx.shape[-1]
    if cur == nnz:
        return p
    if nnz < cur:
        raise ValueError(f"cannot pad nnz {cur} down to {nnz}")
    blocks = torch.nn.functional.pad(p.blocks, (0, 0, 0, 0, 0, nnz - cur))
    idx = torch.nn.functional.pad(p.idx, (0, nnz - cur))
    return PackedBCSC(blocks=blocks, idx=idx, kb=p.kb)


def pad_fraction(block_mask: torch.Tensor, nnz: int | None = None) -> float:
    """Fraction of packed block slots that are zero padding under an
    unbalanced mask (0.0 for a balanced one)."""
    counts = block_mask.sum(dim=-2).cpu().numpy()
    if nnz is None:
        nnz = int(counts.max())
    total = nnz * counts.size
    return float((total - counts.sum()) / total) if total else 0.0


def _host_values(x) -> np.ndarray:
    """A tensor (bfloat16 as float32 values) or numpy array -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def structure_violations(p: PackedBCSC, b_in: int | None = None,
                         b_out: int | None = None,
                         dense_shape: tuple | None = None) -> list[str]:
    """Static structural invariants of a PackedBCSC, checked on host
    arrays (``blocks`` and ``idx`` may be tensors or numpy arrays);
    returns the reference's violation strings (empty = sound):

      * ``blocks`` and ``idx`` shapes agree (and, when given, with the
        configured block dims and the dense leaf shape);
      * every ``idx`` entry lies in ``[0, kb)``: an out-of-range entry
        makes the kernels gather garbage blocks silently;
      * duplicate ``idx`` entries within a column carry only zero blocks
        (the padding convention): a duplicate with data would count that
        block-row twice.
    """
    out: list[str] = []
    blocks = _host_values(p.blocks)
    idx = _host_values(p.idx)
    if idx.dtype != np.int32:
        out.append(f"idx dtype {idx.dtype}, expected int32")
    if blocks.ndim != idx.ndim + 2 or blocks.shape[:-2] != idx.shape:
        return out + [f"blocks shape {blocks.shape} inconsistent with "
                      f"idx shape {idx.shape}"]
    if b_in is not None and (p.b_in, p.b_out) != (b_in, b_out):
        out.append(f"block dims ({p.b_in}, {p.b_out}) != configured "
                   f"({b_in}, {b_out})")
    if dense_shape is not None:
        got = blocks.shape[:-4] + p.dense_shape()
        if tuple(got) != tuple(dense_shape):
            out.append(f"dense extent {got} != expected "
                       f"{tuple(dense_shape)}")
    if idx.size and (idx.min() < 0 or idx.max() >= p.kb):
        out.append(f"idx out of range [0, {p.kb}): "
                   f"min {int(idx.min())}, max {int(idx.max())}")
        return out       # duplicates mean nothing past this
    nnz = idx.shape[-1]
    cols_i = idx.reshape(-1, nnz)
    cols_b = blocks.reshape(-1, nnz, p.b_in * p.b_out)
    nz = np.any(cols_b != 0, axis=-1)                    # (C, nnz)
    order = np.argsort(cols_i, axis=1, kind="stable")
    si = np.take_along_axis(cols_i, order, axis=1)
    sz = np.take_along_axis(nz, order, axis=1)
    dup = si[:, 1:] == si[:, :-1]
    bad = dup & sz[:, 1:] & sz[:, :-1]
    if bad.any():
        c = int(np.argwhere(bad.any(axis=1))[0, 0])
        out.append(f"duplicate idx entries with nonzero blocks in "
                   f"{int(bad.any(axis=1).sum())} column(s) "
                   f"(first: flat column {c}) — block-rows would be "
                   "double-counted")
    return out


def storage_bytes(p: PackedBCSC) -> int:
    """Device bytes of the packed representation."""
    return (p.blocks.numel() * p.blocks.element_size()
            + p.idx.numel() * p.idx.element_size())
