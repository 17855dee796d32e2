"""Server-side distillation (port of ``repro.distill``; paper §3.1.2-§3.1.3,
Eqs. 3-5).

  * ``TeacherBank`` — the K·R temporal-ensemble checkpoints as one stacked
    ring of tensors on the device.
  * ``KDPipeline`` — the KD phase over the dense teacher-probability cache:
    one ``ensemble_softmax`` launch builds the round's cache, then
    ``distill_steps`` steps run through the ``kd_loss`` kernels with no
    host sync inside the loop.
"""
from repro_torch.distill.pipeline import KDPipeline, stack_server_batches
from repro_torch.distill.teacher_bank import TeacherBank

__all__ = ["KDPipeline", "TeacherBank", "stack_server_batches"]
