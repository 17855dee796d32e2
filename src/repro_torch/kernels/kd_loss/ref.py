"""Plain PyTorch versions of the dense ensemble-KD kernels (Eqs. 3-5),
mirroring ``repro/kernels/kd_loss/ref.py``.  The CPU path runs these, and
the on-card check holds ``csrc/kd_loss.cu`` against them."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ensemble_softmax_ref(teacher_logits: torch.Tensor, temperature: float = 1.0):
    """(K, B, V) teacher logits -> (B, V) τ-softmax of the mean logit (Eq. 3/5)."""
    mean = teacher_logits.float().mean(0)
    return F.softmax(mean / temperature, dim=-1)


def kd_loss_ref(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                temperature: float = 1.0):
    """Mean_b KL(t_b ‖ softmax(s_b/τ)) · τ²  (Hinton scaling; Eq. 4)."""
    s = F.log_softmax(student_logits.float() / temperature, dim=-1)
    t = teacher_probs.float()
    kl = (t * (torch.log(t.clamp(min=1e-20)) - s)).sum(-1)
    return kl.mean() * temperature ** 2


def kd_loss_grad_ref(student_logits, teacher_probs, temperature: float = 1.0):
    """Analytic ∂loss/∂student_logits = τ·(softmax(s/τ) − t)/B."""
    B = student_logits.shape[0]
    p = F.softmax(student_logits.float() / temperature, dim=-1)
    return temperature * (p - teacher_probs.float()) / B
