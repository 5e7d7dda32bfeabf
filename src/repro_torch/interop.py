"""numpy <-> torch conversion of parameter trees and train states.

Tests hand the same weights to both packages: the JAX side is brought to
numpy there (``jax.device_get``), and ``to_torch`` turns the nested dict
of arrays into the port's tree, with any packed leaf (an object carrying
``blocks``, ``idx``, ``kb`` and ``joint``) becoming a ``PackedBCSC``.
``to_numpy`` is the reverse. Decode caches are nested dicts of arrays
too (a transformer's ``k``/``v``; rwkv6's ``state``/``x_tmix``/``x_cmix``;
zamba's ``ssm``/``conv``/``k``/``v``; whisper's ``k``/``v``/``ck``/``cv``),
so both packages can start from one cache; whisper's params nest their
``encoder`` and ``decoder`` stacks one level deeper, which the walk
takes as it takes any dict. bfloat16 arrays cross as their 16-bit
pattern, so values are bit-exact both ways; ``to_numpy`` returns them
with numpy's ``bfloat16`` dtype, which exists once ``ml_dtypes`` has been
imported by the caller (JAX does so). ``train_state`` carries a
reference ``TrainState`` across (step, params, masks and the Adam
moments), so both trainers can start from the same state; the port
keeps its own ``torch.Generator`` and does not imitate JAX's PRNG.
``to_torch_shard`` gives one rank its shard of a serving tree for
tensor-parallel serving (an MoE tree's expert packs cut on their experts
dim, the two-matrix MLP's ``w_in`` on its block-columns with ``b_in``
alike and ``w_out`` on its kept blocks, whisper's nested stacks by the
same walk; ``serving/export.py``); a train state crosses whole and is
cut with ``distributed/sharding.py::shard_state``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import PackedBCSC


def tensor(a, *, device) -> torch.Tensor:
    """One numpy array (bfloat16 included) -> torch tensor on ``device``
    (named by every caller: the tests pass "cpu")."""
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


def to_torch(tree, *, device):
    """Nested dict of numpy arrays (and packed leaves) -> torch tree on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    if _is_packed_like(tree):
        return PackedBCSC(blocks=tensor(tree.blocks, device=device),
                          idx=tensor(tree.idx, device=device),
                          kb=int(tree.kb), joint=bool(tree.joint))
    return tensor(tree, device=device)


def to_torch_shard(tree, cfg, mesh, *, device):
    """Nested dict of numpy arrays (a reference serving tree) -> this
    rank's shard of the port's tree on ``device``: the full tree first,
    then ``serving/export.py::shard_params`` on ``mesh``."""
    from repro_torch.serving.export import shard_params
    return shard_params(cfg, to_torch(tree, device=device), mesh)


def to_numpy(tree):
    """Torch tree -> nested dict of numpy arrays; a ``PackedBCSC`` becomes
    a dict with keys blocks, idx, kb, joint."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return {"blocks": array(tree.blocks), "idx": array(tree.idx),
                "kb": tree.kb, "joint": tree.joint}
    return array(tree)


def train_state(state, *, device, seed: int = 0):
    """A reference train state (any object with ``step``, ``params``,
    ``opt_state`` {'m', 'v'} and ``masks``, numpy leaves) -> the port's
    ``training.step.TrainState`` on ``device``."""
    from repro_torch.training.step import TrainState
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(
        step=int(np.asarray(state.step)),
        params=to_torch(state.params, device=device),
        opt_state={k: to_torch(state.opt_state[k], device=device)
                   for k in ("m", "v")},
        masks=to_torch(dict(state.masks), device=device), generator=gen)
