"""Knowledge-distillation loss (port of ``repro/core/distill.py``, paper
§5.2): alpha * CE + beta * KL, with the dense pretrained model as the
teacher of the BLaST-sparsified student.

Under ``dist`` (the sharded train step) the cross-entropy runs on the
rank's vocab shard of the logits where the vocabulary splits over the
model axis: the row max, the sum of exponentials and the target logit
each cross the model axis once (three small all-reduces, the last two
differentiable), so the f32 logits never exist whole on one rank. Its
mean divides by the token count summed over the batch axes, so a
gradient summed over the data ranks is the one-device gradient even
where labels are masked.

The KD term under ``dist`` runs on the vocab shards of both the
student's and the teacher's logits: each temperature-scaled
log-softmax takes its max and its sum of exponentials over the model
axis (``_vp_log_softmax``), and the KL per token is the model-axis sum
of each rank's share of ``p_t · (log p_t - x_s / T)`` plus the student's
global logsumexp times the teacher's total mass (1 up to rounding). The
logsumexp stands outside the local sums so that its gradient reaches
every rank's logits with the whole mass: summed inside them, each rank
would weight its term by its own share of the teacher's mass only. The
mean over tokens divides by the token count over every data rank.
"""
from __future__ import annotations

import torch


def _per_token(logits, labels, dist=None, vocab_parallel=False):
    """logsumexp - target logit per token, f32."""
    logits = logits.float()
    if not vocab_parallel:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.long().clamp_min(0)[..., None])[..., 0]
        return logz - gold
    v = logits.shape[-1]
    with torch.no_grad():
        m = dist.all_reduce(logits.max(dim=-1).values, op="max")
    z = dist.reduce_from_model(torch.exp(logits - m[..., None]).sum(-1))
    local = labels.long().clamp_min(0) - dist.model_rank * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = dist.reduce_from_model(torch.where(mine, gold, 0.0))
    return torch.log(z) + m - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100, dist=None,
                  vocab_parallel: bool = False,
                  count_over_data: bool = True) -> torch.Tensor:
    """Mean token CE over labels != ``ignore_index``; logits (..., V)
    upcast to f32, labels (...) int. Under ``dist``: ``vocab_parallel``
    when the logits are the rank's vocab shard, and with
    ``count_over_data`` the mean divides by the count over every data
    rank (this rank's share of the global mean); without it, by this
    rank's own count (the reference's manual-data semantics)."""
    valid = (labels != ignore_index).float()
    num = (_per_token(logits, labels, dist, vocab_parallel) * valid).sum()
    cnt = valid.sum()
    if dist is not None and count_over_data and dist.data_size > 1:
        cnt = dist.sum_over_data(cnt.detach().clone())
    return num / cnt.clamp_min(1.0)


def _vp_log_softmax(x, dist):
    """(x - logsumexp(x), logsumexp(x)) over the vocab of vocab-sharded
    rows ``x`` (..., V / tp), f32: the max and the sum of exponentials
    cross the model axis (two small all-reduces, the sum
    differentiable)."""
    with torch.no_grad():
        m = dist.all_reduce(x.max(dim=-1).values, op="max")
    z = dist.reduce_from_model(torch.exp(x - m[..., None]).sum(-1))
    lse = torch.log(z) + m
    return x - lse[..., None], lse


def kl_to_teacher(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float = 1.0, dist=None,
                  vocab_parallel: bool = False,
                  count_over_data: bool = True) -> torch.Tensor:
    """KL(teacher || student), mean over tokens, times T^2. Under
    ``dist``: ``vocab_parallel`` when both logits are the rank's vocab
    shard (the module docstring), and ``count_over_data`` as in
    ``cross_entropy`` (every token counts: the reference's mean has no
    mask)."""
    t = temperature
    s = student_logits.float() / t
    with torch.no_grad():
        tl = teacher_logits.float() / t
    if vocab_parallel:
        with torch.no_grad():
            tp, _ = _vp_log_softmax(tl, dist)
            pt = torch.exp(tp)
            mass = dist.all_reduce(pt.sum(-1))
        _, lse = _vp_log_softmax(s, dist)
        kl = dist.reduce_from_model((pt * (tp - s)).sum(-1)) + lse * mass
    else:
        sp = torch.log_softmax(s, dim=-1)
        tp = torch.log_softmax(tl, dim=-1)
        kl = (torch.exp(tp) * (tp - sp)).sum(dim=-1)
    if dist is None:
        return (t * t) * kl.mean()
    n = kl.numel() * (dist.data_size if count_over_data else 1)
    return (t * t) * (kl.sum() / n)


def distill_loss(student_logits, labels, teacher_logits=None, *,
                 alpha: float = 1.0, beta: float = 0.0,
                 temperature: float = 1.0, ignore_index: int = -100,
                 dist=None, vocab_parallel: bool = False,
                 count_over_data: bool = True):
    """alpha * L_CE + beta * L_KL. With beta=0 (or no teacher) this is the
    plain LM loss of pretraining. ``dist``, ``vocab_parallel`` and
    ``count_over_data`` as in ``cross_entropy``."""
    loss = alpha * cross_entropy(student_logits, labels, ignore_index, dist,
                                 vocab_parallel, count_over_data)
    if teacher_logits is not None and beta != 0.0:
        loss = loss + beta * kl_to_teacher(student_logits, teacher_logits,
                                           temperature, dist, vocab_parallel,
                                           count_over_data)
    return loss
