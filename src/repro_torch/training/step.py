"""The train step (port of ``repro/training/step.py``): forward and
backward (STE dense gradients), the in-step blocked prune-and-grow of
paper Listing 1, and the masked AdamW update with pruned-moment reset.

The reference decides skip vs update on the device under ``lax.cond``.
Eager PyTorch cannot branch on a device value without reading it, so the
step reads the loss and the gradient norm once, together, right after
the backward (the step's one host sync; the loop's read of the
metrics follows it), decides on the host, and only then builds the
update. A skipped step returns params, moments and masks unchanged. The
step count is a host int, so the refresh cadence is a Python branch.

Under ``dist`` (the sharded step) knowledge distillation runs as on one
device: an in-step dense teacher forward on the rank's teacher shard
(``sharding.shard_teacher``) gives vocab-sharded logits with no
gradient, or a batch's precomputed whole-vocabulary ``teacher_logits``
(its rows cut with the tokens by ``sharding.slice_batch``) are narrowed
to the rank's vocab slice; ``core/distill.py`` reduces the KL over the
shards. With sequence parallelism (``DistContext.sp``) the replicated
leaves that act on an S shard (``sharding.seq_partial_flags``) get their
partial gradients summed over the model axis after each backward, as do
an expert-parallel MoE layer's router and, under S, its shared experts
(``sharding.partial_flags``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import distill, sparse_mlp as sm
from repro_torch.distributed.context import check_training
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


def init_state(cfg, seed: int = 0, device="cuda", dist=None) -> TrainState:
    """Seeded f32 params, all-kept masks and zero moments on ``device``.
    Under ``dist`` the whole params are drawn (the same numbers as one
    device), then cut to this rank's shard, and the masks and moments
    are made at the shard's shapes."""
    params = registry.init_params(cfg, seed, device)
    if dist is not None:
        from repro_torch.distributed import sharding
        check_training(cfg, dist)
        params = sharding.shard_tree(
            params, sharding.state_shardings(cfg, dist.mesh).params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(step=0, params=params, opt_state=adamw.init(params),
                      masks=registry.init_masks(cfg, params), generator=gen)


def abstract_state(cfg) -> TrainState:
    """Shapes and dtypes of the logical train state (no allocation):
    params, the moments 'm'/'v', the masks and the step (a () int32, as
    in the reference); ``generator`` is None (the port keeps a
    ``torch.Generator``, not JAX's (2,) uint32 key)."""
    from repro_torch.models.params import AbstractParam
    params = registry.abstract_params(cfg)
    masks = {}
    if cfg.blast.enabled:
        for path in registry.sparse_paths(cfg):
            w = sm.get_path(params, path)
            bi, bo = sm.block_dims_for(cfg.blast, path)
            masks[path] = AbstractParam(
                w.shape[:-2] + (w.shape[-2] // bi, w.shape[-1] // bo),
                torch.bool)
    same = lambda t: adamw.tree_map(                      # noqa: E731
        lambda x: AbstractParam(x.shape, x.dtype), t)
    return TrainState(step=AbstractParam((), torch.int32), params=params,
                      opt_state={"m": same(params), "v": same(params)},
                      masks=masks, generator=None)


def loss_fn(cfg, params, masks, batch, teacher_logits=None, kd_alpha=1.0,
            kd_beta=0.0, dist=None, count_over_data=True,
            kd_temperature=1.0):
    """The distillation loss (plus an MoE model's aux term) of one batch;
    whisper's forward also takes ``batch["frames"]`` and a VLM's
    ``batch["patch_embeds"]`` (under ``dist`` the data rank's rows,
    ``sharding.slice_batch``, whole on every model rank; under ``sp``
    each rank places the patches that fall in its S shard). Under
    ``dist`` the forward is the
    rank's shard and the loss this rank's share of the global mean
    (``count_over_data``; False: of its own rows, the deferred step's);
    ``teacher_logits`` are then the rank's vocab shard where the
    student's are, and an MoE model's aux term (its routing of this
    rank's rows) counts as its share of the mean over data ranks.
    ``kd_temperature`` is the KL's temperature (the reference's step
    leaves it at 1)."""
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patch_embeds"] = batch["patch_embeds"]
    logits, aux = registry.forward(cfg, params, batch["tokens"],
                                   masks=masks or None, dist=dist, **kw)
    vp = dist is not None and dist.shards(cfg.vocab_size)
    loss = distill.distill_loss(logits, batch["labels"], teacher_logits,
                                alpha=kd_alpha, beta=kd_beta,
                                temperature=kd_temperature, dist=dist,
                                vocab_parallel=vp,
                                count_over_data=count_over_data)
    if cfg.is_moe:
        share = aux
        if dist is not None and count_over_data:
            share = aux / dist.data_size   # its share of the data mean
        loss = loss + 0.01 * share
    return loss, (logits, aux)


def check_dist_options(cfg, dist, teacher_cfg=None):
    """Refuse what the sharded train step does not cover, before any
    collective: other families (``check_training``), for the student and
    for a teacher of another config."""
    check_training(cfg, dist)
    if teacher_cfg is not None:
        check_training(teacher_cfg, dist)


def teacher_logits_of(cfg, batch, teacher_cfg=None,
                      teacher_params_static=None, dist=None):
    """The KD logits of a step, without gradient: the in-step dense
    teacher forward (on the rank's teacher shard under ``dist``: its
    logits are then the rank's vocab shard), else the batch's
    'teacher_logits', narrowed to the rank's vocab slice under ``dist``
    where the vocabulary splits and they are whole; None without
    either."""
    if teacher_params_static is not None:
        with torch.no_grad():
            return registry.forward(teacher_cfg or cfg,
                                    teacher_params_static, batch["tokens"],
                                    dist=dist)[0]
    tl = batch.get("teacher_logits")
    if (tl is not None and dist is not None
            and dist.shards(cfg.vocab_size)
            and tl.shape[-1] == cfg.vocab_size):
        n = cfg.vocab_size // dist.tp
        tl = tl.narrow(-1, dist.model_rank * n, n)
    return tl


def _partial_grads(grads, flags) -> list:
    """The gradients of the leaves that ``flags``
    (``sharding.partial_flags``) marks, walked by key."""
    if isinstance(grads, dict):
        return [g for k, v in grads.items()
                for g in _partial_grads(v, flags[k])]
    return [grads] if flags else []


def _leaf_params(params):
    """A copy of the tree whose leaves are fresh autograd leaves sharing
    storage with ``params`` (which stay untouched)."""
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def dense_flags_on(cfg):
    """device -> the model's dense-layer flags there (cached per device):
    None (every layer may be pruned: zamba's one shared MLP), a (L,)
    bool tensor, or a dict of them per stack (whisper's encoder and
    decoder); None too without BLaST."""
    cpu = registry.dense_layer_flags(cfg) if cfg.blast.enabled else None
    cache = {"cpu": cpu}

    def on(device):
        if cpu is None:
            return None
        if str(device) not in cache:
            cache[str(device)] = ({k: v.to(device) for k, v in cpu.items()}
                                  if isinstance(cpu, dict)
                                  else cpu.to(device))
        return cache[str(device)]
    return on


def dist_layout(cfg, dist):
    """(per-leaf model-split flags of the params, of the masks, the mask
    specs) of the train state under ``dist``; Nones without one."""
    if dist is None:
        return None, None, None
    from repro_torch.distributed import sharding
    sh = sharding.state_shardings(cfg, dist.mesh)
    return (sharding.shard_flags(sh.params), sharding.shard_flags(sh.masks),
            {p: s.spec for p, s in sh.masks.items()})


def loss_and_grads(cfg, state: TrainState, batch, dist=None,
                   microbatches: int = 1, teacher_logits=None, kd_alpha=1.0,
                   kd_beta=0.0, poison=0.0, over_data: bool = True,
                   kd_temperature=1.0):
    """(loss, aux, dense gradients) of ``batch``, averaged over
    ``microbatches`` slices of it (``teacher_logits`` sliced with it).
    ``poison`` multiplies the loss before the backward (the reported
    loss too). Under ``dist`` with ``over_data``, each rank's loss is its
    share of the global mean and every microbatch's loss and gradients
    are summed over the data axes (as GSPMD reduces them in the
    reference); without, they stay this rank's own, the mean over its
    rows (the deferred step's). An MoE model's aux is then the mean over
    the data ranks, each routing its own rows (the reference's ``pmean``
    inside its shard_map). The partial gradients of replicated leaves
    (``sharding.partial_flags``: the norms where the forward splits the
    stream along S, an MoE router, and its shared experts under S) are
    summed over the model axis first."""
    n = max(microbatches, 1)
    cut = {k: v.chunk(n) for k, v in batch.items()}
    chunks = [{k: v[i] for k, v in cut.items()} for i in range(n)]
    tls = (teacher_logits.chunk(n) if teacher_logits is not None
           else [None] * n)
    reduce = over_data and dist is not None and dist.data_size > 1
    part = None
    if dist is not None and dist.tp > 1:
        from repro_torch.distributed import sharding
        seq_enc = (dist.seq_split(chunks[0]["frames"])
                   if cfg.family == "audio" else None)
        part = sharding.partial_flags(cfg, dist.seq_split(
            tuple(chunks[0]["tokens"].shape) + (cfg.d_model,)), seq_enc)
    total, loss, aux = None, 0.0, 0.0
    for b, tl in zip(chunks, tls):
        leaves = _leaf_params(state.params)
        l_i, (_, a_i) = loss_fn(cfg, leaves, state.masks, b, tl, kd_alpha,
                                kd_beta, dist, count_over_data=over_data,
                                kd_temperature=kd_temperature)
        l_i = l_i * (1.0 + poison)       # the reported loss is poisoned too
        ps = adamw.tree_leaves(leaves)
        gs = torch.autograd.grad(l_i, ps, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for p, g in zip(ps, gs))
        g_i = adamw.tree_map(lambda _: next(it), leaves)
        if part is not None:
            dist.sum_over_model(_partial_grads(g_i, part))
        l_i = l_i.detach()
        if reduce:
            for g in adamw.tree_leaves(g_i):
                dist.sum_over_data(g)
            l_i = dist.sum_over_data(l_i.clone())
            if torch.is_tensor(a_i):
                a_i = dist.mean_over_data(a_i.detach().clone())
        if n == 1:
            return l_i, a_i, g_i
        total = (g_i if total is None
                 else adamw.tree_map(torch.add, total, g_i))
        loss, aux = loss + l_i, aux + a_i
    return loss / n, aux / n, adamw.tree_map(lambda g: g / n, total)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, dist=None, kd_alpha=1.0,
                    kd_beta=0.0, teacher_cfg=None, teacher_params_static=None,
                    microbatches: int = 1, guard: bool = True,
                    grad_norm_limit: float | None = None,
                    kd_temperature: float = 1.0):
    """Build train_step(state, batch) -> (state, metrics).

    ``batch`` holds 'tokens' and 'labels' (B, S) tensors on the params'
    device, and optionally the fault-injection scalars of the reference:
    ``grad_poison`` multiplies the loss by ``1 + poison`` before the
    backward (NaN/Inf poisons every gradient; 0.0 is an exact identity),
    ``loss_poison`` is added to the REPORTED loss only, ``force_skip``
    forces the skip path. ``microbatches`` > 1 accumulates gradients over
    batch slices. ``dist``: the sharded step (module docstring); ``state``
    and ``batch`` are then this rank's shard and rows. With
    ``teacher_params_static`` (under ``dist``, the rank's teacher shard)
    an in-step dense teacher forward supplies the KD logits; a batch may
    also carry 'teacher_logits' (B, S, V) (``teacher_logits_of``).
    ``kd_temperature``: the KL's temperature (the reference's is 1).

    Anomaly guard (``guard``): a non-finite loss or gradient norm, or a
    norm over ``grad_norm_limit``, skips the update. Metrics: 'loss',
    'aux', 'grad_norm', 'lr', 'anomaly' as host numbers; 'sparsity' as a
    device scalar made after the update (0 without BLaST), so that its
    read waits for the whole step on the device."""
    check_dist_options(cfg, dist, teacher_cfg)
    p_flags, m_flags, m_specs = dist_layout(cfg, dist)
    spec = cfg.blast
    dense_flags = dense_flags_on(cfg)

    def train_step(state: TrainState, batch):
        batch = dict(batch)
        poison = {k: float(batch.pop(k, 0.0)) for k in _POISON}
        teacher_logits = teacher_logits_of(cfg, batch, teacher_cfg,
                                           teacher_params_static, dist)

        loss, aux, dense_grads = loss_and_grads(
            cfg, state, batch, dist, microbatches, teacher_logits, kd_alpha,
            kd_beta, poison["grad_poison"], kd_temperature=kd_temperature)

        gnorm = adamw.global_norm(dense_grads, dist, p_flags)
        # the step's one host read: loss and norm together, and an MoE
        # model's aux (a dense model's is the host float 0.0)
        if torch.is_tensor(aux):
            loss_h, gnorm_h, aux_h = torch.stack(
                [loss.float(), gnorm, aux.detach().float()]).tolist()
        else:
            loss_h, gnorm_h = torch.stack([loss.float(), gnorm]).tolist()
            aux_h = float(aux)
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
                dense_flags(loss.device), dist, m_specs)
            grads = sm.mask_grads(masks, dense_grads, spec)
            opt_state = adamw.mask_moments(state.opt_state, masks, spec)
            params, opt_state, _ = adamw.update(opt_cfg, grads, opt_state,
                                                params, state.step, dist,
                                                p_flags)
        else:
            masks = state.masks
            params, opt_state, _ = adamw.update(
                opt_cfg, dense_grads, state.opt_state, state.params,
                state.step, dist, p_flags)

        metrics = {"loss": float(np.float32(loss_h)
                                 + np.float32(poison["loss_poison"])),
                   "aux": aux_h,
                   "sparsity": (sm.tree_sparsity(masks, dist, m_flags)
                                if spec.enabled else loss.new_zeros(())),
                   "grad_norm": gnorm_h,
                   "lr": adamw.lr_at(opt_cfg, state.step),
                   "anomaly": int(anomaly)}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, masks=masks,
                          generator=state.generator), metrics

    return train_step
