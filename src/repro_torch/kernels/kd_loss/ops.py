"""Dense ensemble-KD ops: the Hopper kernels and their plain versions
(port of ``repro/kernels/kd_loss/ops.py``, dense family).

  * ``ensemble_softmax`` / ``ensemble_softmax_many`` — the round's
    teacher-probability cache, ``softmax(mean_m z_m / τ)``;
  * ``kd_loss`` — ``mean_b KL(t ‖ softmax(s/τ))·τ²`` as a
    ``torch.autograd.Function`` (the reference's ``custom_vjp``) over the
    wrappers ``kd_loss_fwd`` and ``kd_loss_bwd``; the teacher is frozen
    (paper Eq. 4) and gets no gradient.

For CUDA tensors each op launches its kernel in ``csrc/kd_loss.cu`` or
raises; the plain versions in ``ref.py`` run only for CPU tensors.  No
padding anywhere: the 128-lane ``keep_pad`` layout of the TPU kernels is
a TPU artifact, and the port returns the true V.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.kd_loss import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _device(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _check(name: str, t: torch.Tensor, what: str, dtypes) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} is {t.dtype}; the kernel takes {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _lib():
    lib = build.load("kd_loss")
    if lib.ensemble_softmax.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ensemble_softmax.argtypes = [vp, vp, i, i, i, f, i, vp]
        lib.kd_loss_fwd.argtypes = [vp, vp, vp, i, i, f, i, vp]
        lib.kd_loss_bwd.argtypes = [vp, vp, vp, vp, i, i, f, f, i, vp]
        for fn in (lib.ensemble_softmax, lib.kd_loss_fwd, lib.kd_loss_bwd):
            fn.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------- ensemble_softmax
def ensemble_softmax(teacher_logits: torch.Tensor, temperature: float = 1.0):
    """(M, N, V) f32|bf16 -> (N, V) f32 τ-softmax of the mean teacher logit
    (Eq. 3/5).  Not differentiable: teachers are frozen."""
    x = teacher_logits.detach()
    if _device("ensemble_softmax", x).type == "cpu":
        return ref.ensemble_softmax_ref(x, temperature)
    _check("ensemble_softmax", x, "teacher_logits", _DTYPES)
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"ensemble_softmax: teacher_logits {tuple(x.shape)}, "
                         f"need (M, N, V)")
    M, N, V = x.shape
    out = torch.empty((N, V), dtype=torch.float32, device=x.device)
    lib = _lib()
    code = lib.ensemble_softmax(x.data_ptr(), out.data_ptr(), M, N, V,
                                1.0 / temperature, _DTYPES[x.dtype], _stream(x.device))
    build.check(lib, code, "ensemble_softmax")
    kernels.launches["ensemble_softmax"] += 1
    return out


def ensemble_softmax_many(teacher_logits: torch.Tensor, temperature: float = 1.0):
    """(M, n_batches, B, V) -> (n_batches, B, V): ensemble probs for the
    whole distillation set in ONE launch over the merged (n_batches·B) rows."""
    M, nB, B, V = teacher_logits.shape
    out = ensemble_softmax(teacher_logits.reshape(M, nB * B, V), temperature)
    return out.reshape(nB, B, V)


# ---------------------------------------------------------------- kd_loss
def _kd_check(name, s, t):
    _check(name, s, "student_logits", _DTYPES)
    _check(name, t, "teacher_probs", (torch.float32,))
    if s.ndim != 2 or s.shape != t.shape or min(s.shape) < 1:
        raise ValueError(f"{name}: student {tuple(s.shape)} and teacher "
                         f"{tuple(t.shape)} must both be (B, V)")


def kd_loss_fwd(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """The loss, a device scalar: per-row KL from the kernel, then
    ``kl.sum() / B · τ²`` as the reference's wrapper takes it."""
    s, t = student_logits, teacher_probs
    if _device("kd_loss_fwd", s, t).type == "cpu":
        return ref.kd_loss_ref(s, t, temperature)
    _kd_check("kd_loss_fwd", s, t)
    B, V = s.shape
    kl = torch.empty((B,), dtype=torch.float32, device=s.device)
    lib = _lib()
    code = lib.kd_loss_fwd(s.data_ptr(), t.data_ptr(), kl.data_ptr(), B, V,
                           1.0 / temperature, _DTYPES[s.dtype], _stream(s.device))
    build.check(lib, code, "kd_loss_fwd")
    kernels.launches["kd_loss_fwd"] += 1
    return kl.sum() / B * temperature ** 2


def kd_loss_bwd(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                g: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """∂(g·loss)/∂student_logits = g·τ·(softmax(s/τ) − t)/B in s's dtype.
    ``g`` is autograd's upstream gradient, a device scalar: the kernel
    reads it in place, so no step waits on the host."""
    s, t = student_logits, teacher_probs
    if _device("kd_loss_bwd", s, t, g).type == "cpu":
        return (ref.kd_loss_grad_ref(s, t, temperature) * g).to(s.dtype)
    _kd_check("kd_loss_bwd", s, t)
    if g.numel() != 1:
        raise ValueError(f"kd_loss_bwd: upstream gradient of shape {tuple(g.shape)}")
    g = g.detach().to(torch.float32).contiguous()
    B, V = s.shape
    out = torch.empty_like(s)
    lib = _lib()
    code = lib.kd_loss_bwd(s.data_ptr(), t.data_ptr(), g.data_ptr(), out.data_ptr(),
                           B, V, 1.0 / temperature, temperature / B,
                           _DTYPES[s.dtype], _stream(s.device))
    build.check(lib, code, "kd_loss_bwd")
    kernels.launches["kd_loss_bwd"] += 1
    return out


class _KDLoss(torch.autograd.Function):
    """The reference's ``custom_vjp``: forward through ``kd_loss_fwd``,
    backward through ``kd_loss_bwd``, no gradient for the teacher."""

    @staticmethod
    def forward(ctx, student_logits, teacher_probs, temperature):
        ctx.save_for_backward(student_logits, teacher_probs)
        ctx.temperature = temperature
        return kd_loss_fwd(student_logits, teacher_probs, temperature)

    @staticmethod
    def backward(ctx, g):
        s, t = ctx.saved_tensors
        return kd_loss_bwd(s, t, g, ctx.temperature), None, None


def kd_loss(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
            temperature: float = 1.0):
    """mean_b KL(teacher ‖ softmax(student/τ))·τ², differentiable in the
    student logits only (teachers are constants, paper Eq. 4)."""
    return _KDLoss.apply(student_logits, teacher_probs.detach(), float(temperature))
