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
where labels are masked. The KD term is not ported under ``dist``.
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


def kl_to_teacher(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student), mean over tokens, times T^2."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = (torch.exp(tp) * (tp - sp)).sum(dim=-1)
    return (t * t) * kl.mean()


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
        if dist is not None:
            raise NotImplementedError(
                "the KD term under dist= is not ported (ROADMAP §1 item 4: "
                "the KD term under dist=)")
        loss = loss + beta * kl_to_teacher(student_logits, teacher_logits,
                                           temperature)
    return loss
