"""numpy <-> torch conversion of parameter trees and train states.

Tests hand the same weights to both packages: the JAX side is brought to
numpy there (``jax.device_get``), and ``to_torch`` turns the nested dict
of arrays into the port's tree, with any packed leaf (an object carrying
``blocks``, ``idx``, ``kb`` and ``joint``) becoming a ``PackedBCSC``.
``to_numpy`` is the reverse. bfloat16 arrays cross as their 16-bit
pattern, so values are bit-exact both ways; ``to_numpy`` returns them
with numpy's ``bfloat16`` dtype, which exists once ``ml_dtypes`` has been
imported by the caller (JAX does so). ``train_state`` carries a
reference ``TrainState`` across (step, params, masks and the Adam
moments), so both trainers can start from the same state; the port
keeps its own ``torch.Generator`` and does not imitate JAX's PRNG.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import PackedBCSC


def tensor(a, device="cpu") -> torch.Tensor:
    """One numpy array (bfloat16 included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def array(t: torch.Tensor) -> np.ndarray:
    """One torch tensor -> numpy array (bfloat16 kept bit-exact)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def _is_packed_like(x) -> bool:
    return all(hasattr(x, a) for a in ("blocks", "idx", "kb", "joint"))


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays (and packed leaves) -> torch tree."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if _is_packed_like(tree):
        return PackedBCSC(blocks=tensor(tree.blocks, device),
                          idx=tensor(tree.idx, device),
                          kb=int(tree.kb), joint=bool(tree.joint))
    return tensor(tree, device)


def to_numpy(tree):
    """Torch tree -> nested dict of numpy arrays; a ``PackedBCSC`` becomes
    a dict with keys blocks, idx, kb, joint."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return {"blocks": array(tree.blocks), "idx": array(tree.idx),
                "kb": tree.kb, "joint": tree.joint}
    return array(tree)


def train_state(state, device="cpu", seed: int = 0):
    """A reference train state (any object with ``step``, ``params``,
    ``opt_state`` {'m', 'v'} and ``masks``, numpy leaves) -> the port's
    ``training.step.TrainState`` on ``device``."""
    from repro_torch.training.step import TrainState
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(
        step=int(np.asarray(state.step)),
        params=to_torch(state.params, device),
        opt_state={k: to_torch(state.opt_state[k], device)
                   for k in ("m", "v")},
        masks=to_torch(dict(state.masks), device), generator=gen)
