"""Knowledge-distillation loss (port of ``repro/core/distill.py``, paper
§5.2): alpha * CE + beta * KL, with the dense pretrained model as the
teacher of the BLaST-sparsified student."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean token CE over labels != ``ignore_index``; logits (..., V)
    upcast to f32, labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp_min(0)[..., None])[..., 0]
    valid = (labels != ignore_index).float()
    return ((logz - gold) * valid).sum() / valid.sum().clamp_min(1.0)


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
                 temperature: float = 1.0, ignore_index: int = -100):
    """alpha * L_CE + beta * L_KL. With beta=0 (or no teacher) this is the
    plain LM loss of pretraining."""
    loss = alpha * cross_entropy(student_logits, labels, ignore_index)
    if teacher_logits is not None and beta != 0.0:
        loss = loss + beta * kl_to_teacher(student_logits, teacher_logits,
                                           temperature)
    return loss
