"""BSpMM entry points: plain PyTorch versions and device dispatch (port of
``repro/kernels/ops.py`` + ``repro/kernels/ref.py``).

``bspmm``, ``fused_glu``, ``sparse_mlp_apply`` and ``bspmm_t`` launch the
CUDA kernels of ``kernels/bspmm.py`` and ``kernels/bspmm_t.py`` for a
CUDA tensor and use the ``*_plain`` versions for a CPU tensor. The plain
versions copy the reference's XLA twins (gather + einsum, f32
accumulation, gate and up rounded to the input dtype before the
activation); tests and ``chip_smoke.py`` call them directly as the
kernels' oracle. ``make_bspmm_trainable`` is the packed matmul with a
sparse backward (the fine-tuning stage at fixed masks).
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedBCSC
from repro_torch.kernels import bspmm as _k
from repro_torch.kernels import bspmm_t as _kt


def _contract_gathered(xg: torch.Tensor, blocks: torch.Tensor,
                       out_dtype) -> torch.Tensor:
    """(M, Nb, nnz, b_in) gathered X tiles @ (Nb, nnz, b_in, b_out) blocks
    -> (M, N), summed in f32 (the products of bf16 values are exact in
    f32, as under preferred_element_type=f32)."""
    m = xg.shape[0]
    nb, _, _, b_out = blocks.shape
    y = torch.einsum("mjnb,jnbo->mjo", xg.float(), blocks.float())
    return y.reshape(m, nb * b_out).to(out_dtype)


def _gather(x: torch.Tensor, p: PackedBCSC) -> torch.Tensor:
    m = x.shape[0]
    return x.reshape(m, p.kb, p.b_in)[:, p.idx.long()]   # (M, Nb, nnz, bi)


def bspmm_plain(x: torch.Tensor, packed: PackedBCSC) -> torch.Tensor:
    """Y = X @ W, packed balanced BCSC, as gather + einsum."""
    return _contract_gathered(_gather(x, packed), packed.blocks, x.dtype)


def fused_glu_plain(x: torch.Tensor, p_gate: PackedBCSC, p_up: PackedBCSC,
                    act: str = "silu") -> torch.Tensor:
    """act(X Wg) * (X Wu), both packed; one gather of X when the pair is
    marked joint."""
    from repro_torch.core.sparse_mlp import act_fn
    if p_gate.joint and p_up.joint:
        xg = _gather(x, p_gate)
        hg = _contract_gathered(xg, p_gate.blocks, x.dtype).float()
        hu = _contract_gathered(xg, p_up.blocks, x.dtype).float()
    else:
        hg = bspmm_plain(x, p_gate).float()
        hu = bspmm_plain(x, p_up).float()
    return (act_fn(act)(hg) * hu).to(x.dtype)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no BSpMM implementation for device {x.device}")


def bspmm(x: torch.Tensor, packed: PackedBCSC) -> torch.Tensor:
    if _on_cuda(x):
        return _k.bspmm(x, packed)
    return bspmm_plain(x, packed)


def fused_glu(x: torch.Tensor, p_gate: PackedBCSC, p_up: PackedBCSC, *,
              act: str = "silu") -> torch.Tensor:
    if _on_cuda(x):
        return _k.fused_glu(x, p_gate, p_up, act=act)
    return fused_glu_plain(x, p_gate, p_up, act)


def sparse_mlp_apply(x: torch.Tensor, p_gate: PackedBCSC, p_up: PackedBCSC,
                     p_down: PackedBCSC, *, act: str = "silu") -> torch.Tensor:
    """Paper Eq. (1): Y = (act(X Wg) * (X Wu)) Wd, all three packed: one
    fused GLU kernel, then one BSpMM."""
    return bspmm(fused_glu(x, p_gate, p_up, act=act), p_down)


def bspmm_t_plain(dy: torch.Tensor, packed: PackedBCSC) -> torch.Tensor:
    """dX = dY @ W^T: per-(column, k) partials summed in f32 into the K
    block grid, rounded once to dY's dtype (``bspmm_t_xla``)."""
    m = dy.shape[0]
    nb, nnz, b_in, b_out = packed.blocks.shape
    parts = torch.einsum("mjo,jkio->mjki", dy.reshape(m, nb, b_out).float(),
                         packed.blocks.float())
    dxb = torch.zeros((m, packed.kb, b_in), dtype=torch.float32,
                      device=dy.device)
    dxb.index_add_(1, packed.idx.reshape(-1).long(),
                   parts.reshape(m, nb * nnz, b_in))
    return dxb.reshape(m, packed.kb * b_in).to(dy.dtype)


def bspmm_t(dy: torch.Tensor, packed: PackedBCSC,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """``table``: the kernel's transposed table
    (``kernels/bspmm_t.device_table``), built per call when omitted."""
    if _on_cuda(dy):
        return _kt.bspmm_t(dy, packed, table)
    return bspmm_t_plain(dy, packed)


def bspmm_grad_blocks(x: torch.Tensor, dy: torch.Tensor,
                      packed: PackedBCSC) -> torch.Tensor:
    """dW blocks: kept block (j, k) gets X[:, idx[j, k]]^T @ dY_j,
    gathered, with no dense dW; f32 sums in the blocks' dtype."""
    m = x.shape[0]
    nb, _, _, b_out = packed.blocks.shape
    dyb = dy.reshape(m, nb, b_out).float()
    return torch.einsum("mjki,mjo->jkio", _gather(x, packed).float(),
                        dyb).to(packed.blocks.dtype)


class _TrainableBSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, idx, kb, table):
        ctx.save_for_backward(x, blocks)
        ctx.idx, ctx.kb, ctx.table = idx, kb, table
        return bspmm(x, PackedBCSC(blocks, idx, kb))

    @staticmethod
    def backward(ctx, dy):
        x, blocks = ctx.saved_tensors
        p = PackedBCSC(blocks, ctx.idx, ctx.kb)
        dy = dy.contiguous()
        dx = bspmm_t(dy, p, ctx.table) if ctx.needs_input_grad[0] else None
        db = (bspmm_grad_blocks(x, dy, p) if ctx.needs_input_grad[1]
              else None)
        return dx, db, None, None, None


def make_bspmm_trainable(idx: torch.Tensor, kb: int):
    """Factory: Y = X @ W with a SPARSE backward for a FIXED mask
    structure (idx closed over: the paper's fine-tuning stage at final
    sparsity). Returns f(x, blocks): the forward is ``bspmm``, dX the
    transposed BSpMM and dBlocks ``bspmm_grad_blocks``, each on kept
    blocks only. For a CUDA idx the kernel's transposed table is built
    here, once (one host copy of idx), not per call."""
    idx = idx.contiguous()
    table = _kt.device_table(idx, kb) if _on_cuda(idx) else None

    def f(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
        return _TrainableBSpMM.apply(x, blocks, idx, kb, table)
    return f


def flops_bspmm(m: int, packed: PackedBCSC) -> int:
    """True sparse FLOPs of one BSpMM call."""
    nb, nnz, b_in, b_out = packed.blocks.shape[-4:]
    return 2 * m * nb * nnz * b_in * b_out


def flops_dense(m: int, k: int, n: int) -> int:
    return 2 * m * k * n
