"""Launchers of the hand-written BSpMM and fused-GLU CUDA kernels
(``csrc/bspmm.cu``), which replace the Pallas kernels of
``repro/kernels/bspmm.py``.

These functions take CUDA tensors only and always launch their kernel;
``kernels/ops.py`` holds the plain PyTorch versions and sends a CPU
tensor there. Every launch adds one to its entry in ``LAUNCHES``, so a
run can show that it went through the kernels.

``bspmm`` and both ``fused_glu`` kernels run the shared main loops of
``csrc/bsp_mma.cuh`` (the GLU in their split or joint GLU mode). Their
split plan (``split_plan.py``) depends on shapes alone: every column of
a balanced pack is a run of nnz consecutive slots, so the chunk bounds of
a (Nb, nnz, splits) are built once and cached on the device, never per
call, and the kernel and split are chosen once per (M, shape, dtype,
GLU mode).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.packing import PackedBCSC, pad_nnz
from repro_torch.kernels import build, split_plan

LAUNCHES = {"bspmm": 0, "fused_glu_split": 0, "fused_glu_joint": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bspmm_launch": [_P] * 5 + [_I] * 14 + [_P],
    "fused_glu_split_launch": [_P] * 7 + [_I] * 15 + [_P],
    "fused_glu_joint_launch": [_P] * 6 + [_I] * 15 + [_P],
}


@functools.cache
def _fn(name: str):
    f = getattr(build.library("bspmm.cu"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


def _check_operands(x: torch.Tensor, packs: list[PackedBCSC]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (M, K) matrix, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (f32 or bf16)")
    for p in packs:
        b, i = p.blocks, p.idx
        if b.dim() != 4 or i.dim() != 2 or tuple(i.shape) != tuple(b.shape[:2]):
            raise ValueError(f"packed operand must be one matrix: blocks "
                             f"{tuple(b.shape)}, idx {tuple(i.shape)}")
        if b.device != x.device or i.device != x.device:
            raise ValueError("operands on different devices")
        if not (b.is_contiguous() and i.is_contiguous()):
            raise ValueError("packed blocks and idx must be contiguous")
        if i.dtype != torch.int32:
            raise TypeError(f"idx dtype {i.dtype}, expected int32")
        if not (b.dtype == x.dtype or (x.dtype == torch.float32
                                       and b.dtype == torch.bfloat16)):
            raise TypeError(f"weights {b.dtype} with x {x.dtype} not "
                            "supported")
        if p.kb * p.b_in != x.shape[1]:
            raise ValueError(f"x has K={x.shape[1]}, weight has "
                             f"{p.kb} x {p.b_in} rows")
        if p.b_out > split_plan.FMA_BN and p.b_out % split_plan.FMA_BN:
            raise ValueError(f"b_out={p.b_out} must be at most "
                             f"{split_plan.FMA_BN} or a multiple of it")


def _common(x: torch.Tensor, p: PackedBCSC):
    dev = device_index(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nb, nnz, b_in, b_out = p.blocks.shape
    out = torch.empty((x.shape[0], nb * b_out), dtype=x.dtype,
                      device=x.device)
    return out, dev, stream, (x.shape[0], x.shape[1], nb, nnz, b_in, b_out)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@functools.cache
def n_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else \
        torch.cuda.current_device()


def aligned16(*ptrs_and_strides: int) -> bool:
    """Every pointer and byte stride given is a multiple of 16."""
    return all(v % 16 == 0 for v in ptrs_and_strides)


def launch_plan(x: torch.Tensor, packed: PackedBCSC,
                p_up: PackedBCSC | None = None) -> split_plan.Launch:
    """The kernel and split ``bspmm`` takes for these operands, or, with
    ``p_up``, ``fused_glu`` (``packed`` its gate; the joint GLU when both
    carry the ``joint`` promise)."""
    nb, nnz, b_in, b_out = packed.blocks.shape
    ea, ew = x.element_size(), packed.blocks.element_size()
    ptrs = [x.data_ptr(), packed.blocks.data_ptr()]
    if p_up is not None:
        ptrs.append(p_up.blocks.data_ptr())
    ok = aligned16(*ptrs, x.shape[1] * ea, b_in * ea, b_out * ew)
    return split_plan.choose(
        x.shape[0], b_in, b_out, nb, nnz, nb * nnz,
        bf16=x.dtype == packed.blocks.dtype == torch.bfloat16, a_size=ea,
        w_size=ew, aligned=ok, n_sm=n_sms(device_index(x)),
        glu=p_up is not None,
        joint=p_up is not None and packed.joint and p_up.joint)


@functools.cache
def column_bounds(device: str, nb: int, nnz: int,
                  splits: int) -> torch.Tensor:
    """(Nb, splits + 1) int32 chunk starts of the balanced columns' visit
    lists (slots j * nnz + k), on ``device``; built once per key."""
    b = split_plan.split_bounds(np.full(nb, nnz), splits)
    return torch.from_numpy(b).to(device)


def bspmm(x: torch.Tensor, packed: PackedBCSC) -> torch.Tensor:
    """Y = X @ W with W packed balanced BCSC; (M, K) -> (M, Nb*b_out) in
    X's dtype, f32 accumulation, one rounding."""
    _check_operands(x, [packed])
    out, dev, stream, dims = _common(x, packed)
    lp = launch_plan(x, packed)
    bounds = column_bounds(str(x.device), packed.nb, packed.nnz, lp.splits)
    rc = _fn("bspmm_launch")(
        x.data_ptr(), packed.blocks.data_ptr(), packed.idx.data_ptr(),
        bounds.data_ptr(), out.data_ptr(), *dims, lp.n_split, lp.splits,
        lp.kernel.kid, lp.bn, lp.bk, DTYPE_CODES[x.dtype],
        DTYPE_CODES[packed.blocks.dtype], dev, stream)
    _raise_on(rc, "bspmm")
    LAUNCHES["bspmm"] += 1
    return out


def fused_glu(x: torch.Tensor, p_gate: PackedBCSC, p_up: PackedBCSC, *,
              act: str = "silu") -> torch.Tensor:
    """H = act(X Wg) * (X Wu) in one kernel, a GLU mode of
    ``bsp_mma.cuh``: joint when both operands carry the ``joint`` promise
    (one idx table, each X tile staged once per visit), else split (two
    idx tables); f32 sums, the activation on them, one rounding."""
    if act not in ACT_IDS:
        raise ValueError(f"act {act!r} not in {sorted(ACT_IDS)}")
    if p_gate.nnz != p_up.nnz:   # align with zero blocks (exact)
        nnz = max(p_gate.nnz, p_up.nnz)
        p_gate, p_up = pad_nnz(p_gate, nnz), pad_nnz(p_up, nnz)
    if p_gate.blocks.shape != p_up.blocks.shape:
        raise ValueError(f"gate {tuple(p_gate.blocks.shape)} and up "
                         f"{tuple(p_up.blocks.shape)} blocks differ")
    if p_gate.blocks.dtype != p_up.blocks.dtype:
        raise TypeError("gate and up weights differ in dtype")
    _check_operands(x, [p_gate, p_up])
    out, dev, stream, dims = _common(x, p_gate)
    lp = launch_plan(x, p_gate, p_up)
    bounds = column_bounds(str(x.device), p_gate.nb, p_gate.nnz, lp.splits)
    rest = (bounds.data_ptr(), out.data_ptr(), *dims, lp.n_split, lp.splits,
            lp.kernel.kid, lp.bn, lp.bk, ACT_IDS[act], DTYPE_CODES[x.dtype],
            DTYPE_CODES[p_gate.blocks.dtype], dev, stream)
    if p_gate.joint and p_up.joint:
        name = "fused_glu_joint"
        rc = _fn("fused_glu_joint_launch")(
            x.data_ptr(), p_gate.blocks.data_ptr(), p_gate.idx.data_ptr(),
            p_up.blocks.data_ptr(), *rest)
    else:
        name = "fused_glu_split"
        rc = _fn("fused_glu_split_launch")(
            x.data_ptr(), p_gate.blocks.data_ptr(), p_gate.idx.data_ptr(),
            p_up.blocks.data_ptr(), p_up.idx.data_ptr(), *rest)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
