"""Launcher of the hand-written transposed BSpMM CUDA kernel
(``csrc/bspmm_t.cu``), which replaces the Pallas kernel of
``repro/kernels/bspmm_t.py``: dX = dY @ W^T for W packed balanced BCSC,
the backward that makes packed weights trainable.

The TPU kernel accumulates into revisited output tiles in the order of
its sequential grid. On the GPU one thread block owns each output tile
instead and walks a host-built transposed table (``transposed_table``):
for every output block-row, the flat slots ``j * nnz + k`` of the kept
blocks that land there. ``bspmm_t`` takes CUDA tensors only and always
launches the kernel; ``kernels/ops.py`` holds the plain PyTorch version
and sends a CPU tensor there. Every launch adds one to
``LAUNCHES["bspmm_t"]``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.packing import PackedBCSC
from repro_torch.kernels import build
from repro_torch.kernels.bspmm import DTYPE_CODES

LAUNCHES = {"bspmm_t": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    f = build.library("bspmm_t.cu").bspmm_t_launch
    f.argtypes = [_P] * 4 + [_I] * 10 + [_P]
    f.restype = ctypes.c_int
    return f


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


def device_table(idx: torch.Tensor, kb: int) -> torch.Tensor:
    """``transposed_table`` of ``idx`` as an int32 tensor on idx's device
    (one device-to-host copy of idx, one host-to-device copy back)."""
    return torch.from_numpy(transposed_table(idx, kb)).to(idx.device)


def _check(dy: torch.Tensor, p: PackedBCSC, table: torch.Tensor) -> None:
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
    if b.device != dy.device or table.device != dy.device:
        raise ValueError("operands on different devices")
    if not (b.is_contiguous() and table.is_contiguous()):
        raise ValueError("packed blocks and the table must be contiguous")
    if table.dtype != torch.int32:
        raise TypeError(f"table dtype {table.dtype}, expected int32")
    if table.dim() != 2 or table.shape[0] != p.kb:
        raise ValueError(f"table {tuple(table.shape)} does not have "
                         f"{p.kb} block-rows")
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


def bspmm_t(dy: torch.Tensor, packed: PackedBCSC,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """dX = dY @ W^T: (M, Nb*b_out) -> (M, Kb*b_in) in dY's dtype, f32
    accumulation, one rounding. ``table`` is ``device_table(packed.idx,
    packed.kb)``; without it the table is built here, which copies idx to
    the host (as the reference wrapper's ``device_get`` does)."""
    if table is None:
        table = device_table(packed.idx, packed.kb)
    _check(dy, packed, table)
    dev = dy.device.index if dy.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    nb, nnz, b_in, b_out = packed.blocks.shape
    out = torch.empty((dy.shape[0], packed.kb * b_in), dtype=dy.dtype,
                      device=dy.device)
    rc = _fn()(dy.data_ptr(), packed.blocks.data_ptr(), table.data_ptr(),
               out.data_ptr(), dy.shape[0], packed.kb, nb, nnz,
               table.shape[1], b_in, b_out, DTYPE_CODES[dy.dtype],
               DTYPE_CODES[packed.blocks.dtype], dev, stream)
    if rc != 0:
        raise RuntimeError(f"bspmm_t kernel launch failed: CUDA error {rc}")
    LAUNCHES["bspmm_t"] += 1
    return out
