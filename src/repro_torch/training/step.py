"""The train step (port of ``repro/training/step.py``): forward and
backward (STE dense gradients), the in-step blocked prune-and-grow of
paper Listing 1, and the masked AdamW update with pruned-moment reset.

The reference decides skip vs update on the device under ``lax.cond``.
Eager PyTorch cannot branch on a device value without reading it, so the
step reads the loss and the gradient norm once, together, right after
the backward (the one host sync of a step; the loop reads the loss from
it and adds no other), decides on the host, and only then builds the
update. A skipped step returns params, moments and masks unchanged. The
step count is a host int, so the refresh cadence is a Python branch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import distill, sparse_mlp as sm
from repro_torch.models import registry
from repro_torch.optim import adamw

_POISON = ("grad_poison", "loss_poison", "force_skip")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    masks: Any
    generator: torch.Generator


def init_state(cfg, seed: int = 0, device="cuda") -> TrainState:
    """Seeded f32 params, all-kept masks and zero moments on ``device``."""
    params = registry.init_params(cfg, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(step=0, params=params, opt_state=adamw.init(params),
                      masks=registry.init_masks(cfg, params), generator=gen)


def loss_fn(cfg, params, masks, batch, teacher_logits=None, kd_alpha=1.0,
            kd_beta=0.0):
    logits, aux = registry.forward(cfg, params, batch["tokens"],
                                   masks=masks or None)
    loss = distill.distill_loss(logits, batch["labels"], teacher_logits,
                                alpha=kd_alpha, beta=kd_beta)
    return loss, (logits, aux)


def _leaf_params(params):
    """A copy of the tree whose leaves are fresh autograd leaves sharing
    storage with ``params`` (which stay untouched)."""
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, kd_alpha=1.0,
                    kd_beta=0.0, teacher_cfg=None, teacher_params_static=None,
                    microbatches: int = 1, guard: bool = True,
                    grad_norm_limit: float | None = None):
    """Build train_step(state, batch) -> (state, metrics).

    ``batch`` holds 'tokens' and 'labels' (B, S) tensors on the params'
    device, and optionally the fault-injection scalars of the reference:
    ``grad_poison`` multiplies the loss by ``1 + poison`` before the
    backward (NaN/Inf poisons every gradient; 0.0 is an exact identity),
    ``loss_poison`` is added to the REPORTED loss only, ``force_skip``
    forces the skip path. ``microbatches`` > 1 accumulates gradients over
    batch slices. With ``teacher_params_static`` an in-step dense teacher
    forward supplies the KD logits; a batch may also carry
    'teacher_logits'.

    Anomaly guard (``guard``): a non-finite loss or gradient norm, or a
    norm over ``grad_norm_limit``, skips the update. Metrics: 'loss',
    'aux', 'grad_norm', 'lr', 'anomaly' as host numbers; 'sparsity' as a
    device scalar, read by whoever logs it."""
    spec = cfg.blast
    flags = {"cpu": registry.dense_layer_flags(cfg)} if spec.enabled else None

    def dense_flags(device):
        if flags is None:
            return None
        if str(device) not in flags:
            flags[str(device)] = flags["cpu"].to(device)
        return flags[str(device)]

    def grads_of(state, b, tl, poison):
        leaves = _leaf_params(state.params)
        loss, (_, aux) = loss_fn(cfg, leaves, state.masks, b, tl, kd_alpha,
                                 kd_beta)
        loss = loss * (1.0 + poison)       # the reported loss is poisoned too
        ps = adamw.tree_leaves(leaves)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for p, g in zip(ps, gs))
        return loss.detach(), aux, adamw.tree_map(lambda _: next(it),
                                                  leaves)

    def train_step(state: TrainState, batch):
        batch = dict(batch)
        poison = {k: float(batch.pop(k, 0.0)) for k in _POISON}
        teacher_logits = batch.get("teacher_logits")
        if teacher_params_static is not None:
            with torch.no_grad():
                teacher_logits, _ = registry.forward(
                    teacher_cfg or cfg, teacher_params_static,
                    batch["tokens"])

        if microbatches <= 1:
            loss, aux, dense_grads = grads_of(state, batch, teacher_logits,
                                              poison["grad_poison"])
        else:
            n = microbatches
            chunks = {k: v.chunk(n) for k, v in batch.items()}
            tls = (teacher_logits.chunk(n) if teacher_logits is not None
                   else [None] * n)
            dense_grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            loss, aux = 0.0, 0.0
            for i in range(n):
                l_i, a_i, g_i = grads_of(
                    state, {k: v[i] for k, v in chunks.items()}, tls[i],
                    poison["grad_poison"])
                dense_grads = adamw.tree_map(torch.add, dense_grads, g_i)
                loss, aux = loss + l_i, aux + a_i
            dense_grads = adamw.tree_map(lambda g: g / n, dense_grads)
            loss, aux = loss / n, aux / n

        gnorm = adamw.global_norm(dense_grads)
        # the step's one host read: loss and norm together
        loss_h, gnorm_h = torch.stack([loss.float(), gnorm]).tolist()
        anomaly = False
        if guard:
            ok = math.isfinite(loss_h) and math.isfinite(gnorm_h)
            if grad_norm_limit is not None:
                ok = ok and gnorm_h <= grad_norm_limit
            anomaly = not ok
        anomaly = anomaly or poison["force_skip"] > 0

        if anomaly:
            params, opt_state, masks = (state.params, state.opt_state,
                                        state.masks)
        elif spec.enabled:
            # refresh from the old params and the dense grads, then mask
            # grads and moments with the new masks; AdamW clips the
            # masked grads
            masks, params, _ = sm.maybe_refresh(
                spec, state.params, dense_grads, state.masks, state.step,
                dense_flags(loss.device))
            grads = sm.mask_grads(masks, dense_grads, spec)
            opt_state = adamw.mask_moments(state.opt_state, masks, spec)
            params, opt_state, _ = adamw.update(opt_cfg, grads, opt_state,
                                                params, state.step)
        else:
            masks = state.masks
            params, opt_state, _ = adamw.update(
                opt_cfg, dense_grads, state.opt_state, state.params,
                state.step)

        metrics = {"loss": float(np.float32(loss_h)
                                 + np.float32(poison["loss_poison"])),
                   "aux": float(aux),
                   "sparsity": (sm.tree_sparsity(masks) if spec.enabled
                                else 0.0),
                   "grad_norm": gnorm_h,
                   "lr": adamw.lr_at(opt_cfg, state.step),
                   "anomaly": int(anomaly)}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, masks=masks,
                          generator=state.generator), metrics

    return train_step
