"""Server-side distillation (port of ``repro.distill``; paper §3.1.2-§3.1.3,
Eqs. 3-5).

  * ``TeacherBank`` — the K·R temporal-ensemble checkpoints as one stacked
    ring of tensors on the device.
  * ``KDPipeline`` — the KD phase: the round's teacher cache is built once
    (dense probabilities through one ``ensemble_softmax`` launch, or the
    Flash-KD mean-logit cache and its normaliser), then ``distill_steps``
    steps run through the KD kernels (``kd_loss``, ``flash_kd_loss`` or the
    head-fused ``flash_kd_head_loss``) with no host sync inside the loop.
"""
from repro_torch.distill.pipeline import KDPipeline, stack_server_batches
from repro_torch.distill.teacher_bank import TeacherBank

__all__ = ["KDPipeline", "TeacherBank", "stack_server_batches"]
