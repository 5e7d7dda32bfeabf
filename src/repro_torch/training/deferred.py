"""Deferred (and optionally int8-compressed) data-parallel gradient
reduction (port of ``repro/training/deferred.py``).

The sharded step (``training/step.py`` with ``dist=``) reduces the
gradients over the data axes after every microbatch, as GSPMD does in
the reference. Here each data rank accumulates its gradients unreduced
over its microbatches and they cross the data axes once per step: as an
f32 mean, or through ``optim/compress.py``'s int8 error-feedback
reduction (the error-feedback buffer rides the optimizer state as
'ef'). The model axis stays as in the sharded step: the model calls its
collectives itself. Refresh, masking and AdamW follow the reference's
body; like the reference, the step has no anomaly guard.

A rank's batch is its contiguous rows of the global batch
(``sharding.slice_batch(batch, dist)``), as the reference's shard_map
over the data axes hands it, and its microbatches are cut from those
rows. Its loss is the mean over its own rows (no count crosses the data
axes), averaged over the data ranks once with the gradients.

Distillation and sequence parallelism run as in the sharded step
(``training/step.py``): the in-step teacher on the rank's teacher
shard, or the batch's 'teacher_logits'; the KL, like the cross-entropy,
the mean over the rank's own tokens. The reference's deferred step has
no KD term (its ``loss_fn`` gets no teacher); it keeps ``sp`` on inside
its shard_map, as the port does.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparse_mlp as sm
from repro_torch.optim import adamw, compress
from repro_torch.training.step import (TrainState, check_dist_options,
                                       dense_flags_on, dist_layout,
                                       loss_and_grads, teacher_logits_of)


def make_train_step_deferred(cfg, opt_cfg: adamw.AdamWConfig, dist,
                             microbatches: int = 1,
                             compress_grads: bool = True, kd_alpha=1.0,
                             kd_beta=0.0, teacher_cfg=None,
                             teacher_params_static=None,
                             kd_temperature: float = 1.0):
    """train_step(state, batch) -> (state, metrics) with ONE (compressed)
    data-axis reduction. ``state.opt_state`` carries 'ef' when
    ``compress_grads`` (``init_opt_state``). The KD options are
    ``step.make_train_step``'s. Metrics: 'loss' and 'grad_norm' (the
    clipped update's norm) as host floats, 'aux', 'lr', and 'sparsity'
    as a device scalar."""
    check_dist_options(cfg, dist, teacher_cfg)
    p_flags, m_flags, m_specs = dist_layout(cfg, dist)
    spec = cfg.blast
    dense_flags = dense_flags_on(cfg)

    def train_step(state: TrainState, batch):
        tl = teacher_logits_of(cfg, batch, teacher_cfg,
                               teacher_params_static, dist)
        loss, aux, g = loss_and_grads(cfg, state, batch, dist, microbatches,
                                      tl, kd_alpha, kd_beta, over_data=False,
                                      kd_temperature=kd_temperature)
        # THE deferred reduction: one pass over the data axes
        if compress_grads:
            dense_grads, new_ef = compress.compressed_psum(
                g, state.opt_state["ef"], dist)
        else:
            if dist is not None:
                for x in adamw.tree_leaves(g):
                    dist.mean_over_data(x)
            dense_grads, new_ef = g, state.opt_state.get("ef", {})
        if dist is not None:
            loss = dist.mean_over_data(loss.clone())

        if spec.enabled:
            masks, params, _ = sm.maybe_refresh(
                spec, state.params, dense_grads, state.masks, state.step,
                dense_flags(loss.device), dist, m_specs)
            grads = sm.mask_grads(masks, dense_grads, spec)
            opt_state = adamw.mask_moments(state.opt_state, masks, spec)
        else:
            masks, params, grads = state.masks, state.params, dense_grads
            opt_state = state.opt_state
        params, mv, om = adamw.update(
            opt_cfg, grads, {"m": opt_state["m"], "v": opt_state["v"]},
            params, state.step, dist, p_flags)
        loss_h, gnorm_h = torch.stack([loss.float(),
                                       om["grad_norm"]]).tolist()
        metrics = {"loss": loss_h, "aux": aux,
                   "sparsity": (sm.tree_sparsity(masks, dist, m_flags)
                                if spec.enabled else loss.new_zeros(())),
                   "grad_norm": gnorm_h, "lr": om["lr"]}
        return TrainState(step=state.step + 1, params=params,
                          opt_state={"m": mv["m"], "v": mv["v"],
                                     "ef": new_ef},
                          masks=masks, generator=state.generator), metrics

    return train_step


def init_opt_state(cfg, params, compress_grads: bool = True):
    """AdamW's moments, plus a zero error-feedback buffer 'ef' when
    ``compress_grads`` (an empty dict otherwise)."""
    st = adamw.init(params)
    st["ef"] = (compress.init_error_feedback(params)
                if compress_grads else {})
    return st
