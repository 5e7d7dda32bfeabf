"""Packed balanced-BCSC representation for serving (port of
``repro/core/packing.py``).

A sparse weight W (K, N) whose block mask keeps the same number ``nnz``
of (b_in, b_out) blocks in every block-column is stored as

    blocks : (..., Nb, nnz, b_in, b_out)   kept block values, column-major
    idx    : (..., Nb, nnz) int32          block-row index of each block

Unbalanced masks are padded with zero blocks at idx 0 (exact). ``kb`` and
``joint`` are plain attributes: ``joint`` promises that this operand's
idx table equals its fused-GLU partner's, so the joint kernel may load
each X tile once for both products.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PackedBCSC:
    blocks: torch.Tensor   # (..., Nb, nnz, b_in, b_out)
    idx: torch.Tensor      # (..., Nb, nnz) int32
    kb: int                # number of block-rows
    joint: bool = False

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

    def layer(self, i: int) -> "PackedBCSC":
        """Views of one entry of the leading (layer) axis."""
        return PackedBCSC(self.blocks[i], self.idx[i], self.kb, self.joint)


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
    """Pack one masked weight (K, N) with block mask (Kb, Nb) into
    balanced BCSC. ``nnz`` defaults to the max per-column count."""
    k, n = w.shape
    kb, nb = k // b_in, n // b_out
    if tuple(block_mask.shape) != (kb, nb):
        raise ValueError(f"mask {tuple(block_mask.shape)} != grid {(kb, nb)}")
    if nnz is None:
        nnz = max_nnz_per_col(block_mask)
    # kept blocks of each column first, in block-row order; the stable
    # sort fixes the idx order the reference produces
    keyed = torch.where(block_mask, 0, 1)
    order = torch.argsort(keyed, dim=0, stable=True)       # (Kb, Nb)
    sel = order[:nnz].T.to(torch.int32)                    # (Nb, nnz)
    valid = torch.gather(block_mask.T, 1, sel.long())      # (Nb, nnz)
    idx = torch.where(valid, sel, torch.zeros_like(sel))
    wb = w.reshape(kb, b_in, nb, b_out).permute(2, 0, 1, 3)  # (Nb,Kb,bi,bo)
    blocks = wb[torch.arange(nb, device=w.device)[:, None], idx.long()]
    blocks = torch.where(valid[:, :, None, None], blocks,
                         torch.zeros((), dtype=w.dtype, device=w.device))
    return PackedBCSC(blocks=blocks.contiguous(), idx=idx.contiguous(),
                      kb=kb)


def unpack(p: PackedBCSC) -> torch.Tensor:
    """Packed (one matrix) -> dense (K, N). Padding blocks are zero, so
    adding them at duplicate idx 0 is exact."""
    nb, nnz, b_in, b_out = p.blocks.shape
    dense = torch.zeros((nb, p.kb, b_in, b_out), dtype=p.blocks.dtype,
                        device=p.blocks.device)
    cols = torch.arange(nb, device=p.blocks.device)[:, None].expand(nb, nnz)
    dense.index_put_((cols, p.idx.long()), p.blocks, accumulate=True)
    return dense.permute(1, 2, 0, 3).reshape(p.kb * b_in, nb * b_out)


def pack_stacked(w: torch.Tensor, block_mask: torch.Tensor, b_in: int,
                 b_out: int, nnz: int) -> PackedBCSC:
    """``pack`` over arbitrary leading dims (layers, experts), the
    leading axes written out as a loop."""
    lead = tuple(w.shape[:-2])
    if not lead:
        return pack(w, block_mask, b_in, b_out, nnz)
    w2 = w.reshape(-1, *w.shape[-2:])
    m2 = block_mask.reshape(-1, *block_mask.shape[-2:])
    parts = [pack(w2[i], m2[i], b_in, b_out, nnz) for i in range(w2.shape[0])]
    blocks = torch.stack([p.blocks for p in parts]).reshape(
        *lead, *parts[0].blocks.shape)
    idx = torch.stack([p.idx for p in parts]).reshape(
        *lead, *parts[0].idx.shape)
    return PackedBCSC(blocks=blocks, idx=idx, kb=w.shape[-2] // b_in)


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


def storage_bytes(p: PackedBCSC) -> int:
    """Device bytes of the packed representation."""
    return (p.blocks.numel() * p.blocks.element_size()
            + p.idx.numel() * p.idx.element_size())
