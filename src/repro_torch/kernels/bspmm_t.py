"""Launcher of the hand-written transposed BSpMM CUDA kernel
(``csrc/bspmm_t.cu``), which replaces the Pallas kernel of
``repro/kernels/bspmm_t.py``: dX = dY @ W^T for W packed balanced BCSC,
the backward that makes packed weights trainable.

The TPU kernel accumulates into revisited output tiles in the order of
its sequential grid. On the GPU each output tile is owned by one cluster
of CTAs instead, which walks a host-built transposed visit list
(``transposed_table``): for every output block-row, the flat slots
``j * nnz + k`` of the kept blocks that land there. ``TransposedPlan``
holds those lists and their chunk bounds for every split on the device,
built once per fixed mask (``ops.make_bspmm_trainable``). ``bspmm_t``
takes CUDA tensors only and always launches the kernel;
``kernels/ops.py`` holds the plain PyTorch version and sends a CPU tensor
there. Every call adds one to ``LAUNCHES["bspmm_t"]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.packing import PackedBCSC
from repro_torch.kernels import build, split_plan
from repro_torch.kernels.bspmm import (DTYPE_CODES, aligned16,
                                       device_index, n_sms)

LAUNCHES = {"bspmm_t": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    f = build.library("bspmm_t.cu").bspmm_t_launch
    f.argtypes = [_P] * 5 + [_I] * 14 + [_P]
    f.restype = ctypes.c_int
    return f


def first_visit_flags(idx, kb: int) -> np.ndarray:
    """(Nb, nnz) int32: 1 where (j, k) is the first occurrence of
    ``idx[j, k]`` in (j, k)-lexicographic order (the TPU kernel's
    zero-init marks for the output tiles it revisits; the CUDA kernel
    owns each tile in one cluster and needs none)."""
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    flat = np.asarray(idx, np.int64).reshape(-1)
    flags = np.zeros(flat.size, np.int32)
    if flat.size:
        if flat.min() < 0 or flat.max() >= kb:
            raise ValueError(f"idx entries outside [0, {kb})")
        flags[np.unique(flat, return_index=True)[1]] = 1
    return flags.reshape(np.shape(idx))


def transposed_table(idx, kb: int) -> np.ndarray:
    """(Kb, V) int32: row r lists the flat slots ``j * nnz + k`` with
    ``idx[j, k] == r`` in (j, k) order, padded with -1 to the largest
    visit count V (at least 1). A block-row no kept block visits is all
    -1. ``idx`` is one matrix's (Nb, nnz) table, a tensor or an array."""
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    flat = np.asarray(idx, np.int64).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= kb):
        raise ValueError(f"idx entries outside [0, {kb})")
    counts = np.bincount(flat, minlength=kb)
    table = np.full((kb, max(int(counts.max(initial=0)), 1)), -1, np.int32)
    order = np.argsort(flat, kind="stable")
    starts = np.cumsum(counts) - counts
    table[flat[order], np.arange(flat.size) - np.repeat(starts, counts)] = order
    return table


@dataclasses.dataclass(frozen=True)
class TransposedPlan:
    """The transposed visit lists of one fixed mask, on a device.

    ``visits``: the rows of ``transposed_table`` without their padding,
    back to back, row r ``lengths[r]`` long. ``bounds[s - 1]``: the
    (Kb, s + 1) int32 chunk starts of split s (``split_plan.split_bounds``),
    for every s in 1..8."""
    visits: torch.Tensor
    bounds: tuple[torch.Tensor, ...]
    lengths: np.ndarray
    kb: int

    @property
    def max_len(self) -> int:
        return int(self.lengths.max(initial=0))

    @property
    def total(self) -> int:
        return int(self.lengths.sum())

    @classmethod
    def build(cls, idx, kb: int, device) -> "TransposedPlan":
        table = transposed_table(idx, kb)
        lengths = (table >= 0).sum(axis=1)
        visits = table[table >= 0]          # row-major: row by row
        if visits.size == 0:                # keep a valid pointer
            visits = np.zeros(1, np.int32)
        bounds = tuple(
            torch.from_numpy(split_plan.split_bounds(lengths, s)).to(device)
            for s in range(1, split_plan.MAX_SPLITS + 1))
        return cls(torch.from_numpy(visits.astype(np.int32)).to(device),
                   bounds, lengths, kb)


def device_plan(idx: torch.Tensor, kb: int) -> TransposedPlan:
    """``TransposedPlan`` of ``idx`` on idx's device (one device-to-host
    copy of idx, one host-to-device copy of the plan)."""
    return TransposedPlan.build(idx, kb, idx.device)


def _check(dy: torch.Tensor, p: PackedBCSC, plan: TransposedPlan) -> None:
    if dy.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dy.device}")
    if dy.dim() != 2 or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous (M, N) matrix, got "
                         f"{tuple(dy.shape)} strides {dy.stride()}")
    if dy.dtype not in DTYPE_CODES:
        raise TypeError(f"dy dtype {dy.dtype} not supported (f32 or bf16)")
    b = p.blocks
    if b.dim() != 4 or tuple(p.idx.shape) != tuple(b.shape[:2]):
        raise ValueError(f"packed operand must be one matrix: blocks "
                         f"{tuple(b.shape)}, idx {tuple(p.idx.shape)}")
    if b.device != dy.device or plan.visits.device != dy.device:
        raise ValueError("operands on different devices")
    if not b.is_contiguous():
        raise ValueError("packed blocks must be contiguous")
    if plan.kb != p.kb:
        raise ValueError(f"plan has {plan.kb} block-rows, weight {p.kb}")
    if plan.total != p.nb * p.nnz:
        raise ValueError(f"plan lists {plan.total} visits, weight has "
                         f"{p.nb} x {p.nnz} slots")
    if not (b.dtype == dy.dtype or (dy.dtype == torch.float32
                                    and b.dtype == torch.bfloat16)):
        raise TypeError(f"weights {b.dtype} with dy {dy.dtype} not "
                        "supported")
    if p.nb * p.b_out != dy.shape[1]:
        raise ValueError(f"dy has N={dy.shape[1]}, weight has "
                         f"{p.nb} x {p.b_out} columns")
    if p.b_in > 256 or 256 % p.b_in:
        raise ValueError(f"b_in={p.b_in} must divide 256")
    if dy.shape[0] == 0:
        raise ValueError("dy has no rows")


def launch_plan(dy: torch.Tensor, packed: PackedBCSC,
                plan: TransposedPlan) -> split_plan.Launch:
    """The kernel and split ``bspmm_t`` takes for these operands."""
    nb, nnz, b_in, b_out = packed.blocks.shape
    ea, ew = dy.element_size(), packed.blocks.element_size()
    ok = aligned16(dy.data_ptr(), packed.blocks.data_ptr(),
                   dy.shape[1] * ea, b_out * ea, b_out * ew)
    return split_plan.choose(
        dy.shape[0], b_out, b_in, plan.kb, plan.max_len, plan.total,
        bf16=dy.dtype == packed.blocks.dtype == torch.bfloat16, a_size=ea,
        w_size=ew, aligned=ok, n_sm=n_sms(device_index(dy)))


def bspmm_t(dy: torch.Tensor, packed: PackedBCSC,
            plan: TransposedPlan | None = None) -> torch.Tensor:
    """dX = dY @ W^T: (M, Nb*b_out) -> (M, Kb*b_in) in dY's dtype, f32
    accumulation, one rounding. ``plan`` is ``device_plan(packed.idx,
    packed.kb)``; without it the plan is built here, which copies idx to
    the host (as the reference wrapper's ``device_get`` does)."""
    if plan is None:
        plan = device_plan(packed.idx, packed.kb)
    _check(dy, packed, plan)
    nb, nnz, b_in, b_out = packed.blocks.shape
    lp = launch_plan(dy, packed, plan)
    out = torch.empty((dy.shape[0], packed.kb * b_in), dtype=dy.dtype,
                      device=dy.device)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    rc = _fn()(dy.data_ptr(), packed.blocks.data_ptr(),
               plan.visits.data_ptr(), plan.bounds[lp.splits - 1].data_ptr(),
               out.data_ptr(), dy.shape[0], packed.kb, nb, nnz, b_in, b_out,
               lp.n_split, lp.splits, lp.kernel.kid, lp.bn, lp.bk,
               DTYPE_CODES[dy.dtype], DTYPE_CODES[packed.blocks.dtype],
               device_index(dy), stream)
    if rc != 0:
        raise RuntimeError(f"bspmm_t kernel launch failed: CUDA error {rc}")
    LAUNCHES["bspmm_t"] += 1
    return out
