"""Dense ensemble-KD ops: the Hopper kernels and their plain versions
(port of ``repro/kernels/kd_loss/ops.py``, dense family).

  * ``ensemble_softmax`` / ``ensemble_softmax_many`` — the round's
    teacher-probability cache, ``softmax(mean_m z_m / τ)``;
  * ``kd_loss`` — ``mean_b KL(t ‖ softmax(s/τ))·τ²`` as a
    ``torch.autograd.Function`` (the reference's ``custom_vjp``) over the
    wrappers ``kd_loss_fwd`` and ``kd_loss_bwd``; the teacher is frozen
    (paper Eq. 4) and gets no gradient.

and the Flash-KD family (kernels 7-10, ``csrc/flash_kd.cu``):

  * ``flash_kd_loss`` — the KL streamed over vocab tiles from the mean
    teacher logit row (bf16-storable) with an online logsumexp, as a
    ``torch.autograd.Function`` over ``flash_kd_fwd`` / ``flash_kd_bwd``;
    the forward saves only the row normalisers (lse_s, lse_t);
  * ``flash_kd_head_loss`` — the same with the LM head fused: features
    ``h`` (B, D) and the head ``W`` (D, V) (+ bias) in, ``h @ W[:, tile]``
    formed inside the kernel, gradients to ``h``, ``W`` and the bias
    through ``flash_kd_head_fwd`` / ``flash_kd_head_bwd``;
  * ``teacher_cache_lse`` — logsumexp(z̄/τ) of the stored cache, in f32.

For CUDA tensors each op launches its kernel or raises; the plain
versions (``ref.py``, ``flash.py``) run only for CPU tensors.  No padding
anywhere: the 128-lane ``keep_pad`` layout of the TPU kernels is a TPU
artifact, and the port returns the true V; the flash kernels mask a
ragged tail in place.  ``tile_v`` sets the plain versions' tile; the
kernels use their own tiles.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.kd_loss import flash, ref

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
        lib.ensemble_softmax.argtypes = [vp, vp, i, i, i, f, i, i, i, i, i, i, i, vp]
        lib.kd_loss_fwd.argtypes = [vp, vp, vp, i, i, f, f, i, i, i, i, i, i, vp]
        lib.kd_loss_bwd.argtypes = [vp, vp, vp, vp, i, i, f, f, i, i, i, i, i, i, vp]
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
    code = lib.ensemble_softmax(x.data_ptr(), out.data_ptr(), M, N, V, 1.0 / temperature,
                                *_ensemble_plan_args(M, N, V, x.element_size()),
                                _DTYPES[x.dtype], _stream(x.device))
    build.check(lib, code, "ensemble_softmax")
    kernels.count("ensemble_softmax", x.device)
    return out


def ensemble_softmax_many(teacher_logits: torch.Tensor, temperature: float = 1.0):
    """(M, n_batches, B, V) -> (n_batches, B, V): ensemble probs for the
    whole distillation set in ONE launch over the merged (n_batches·B) rows."""
    M, nB, B, V = teacher_logits.shape
    out = ensemble_softmax(teacher_logits.reshape(M, nB * B, V), temperature)
    return out.reshape(nB, B, V)


# Kernel 2's launch plan (csrc/kd_loss.cu keeps the same constants); the
# staged path's slices and clusters are kd_plan's, over f32 z.
ENS_SMALL_THREADS = 128       # small: a CTA over a block of whole rows
ENS_STAGED_THREADS = 512      # staged: a CTA over a slice of one row
_ENS_PATHS = {"small": 0, "staged": 1}


def ensemble_plan(M: int, N: int, V: int, elt: int, cluster_max: int | None = None,
                  share: int | None = None) -> dict:
    """Kernel 2's launch for (M, N, V) teacher logits of ``elt`` bytes.

    * ``small`` (V <= 1024): a CTA of ``ENS_SMALL_THREADS`` takes ``rows``
      whole rows (about one 16-byte group of each teacher a thread, at most
      a row a thread; a multiple of the rows that make whole 16-byte
      groups, so that no thread waits on a second, plain load); ``lanes``
      lanes a row (a power of two up to 32 and V's next power of two,
      ``rows * lanes`` within the CTA) form its max and sum and write it;
      ``grid`` CTAs;
    * ``staged``: a cluster of ``cluster`` CTAs a row, CTA q owning
      ``slices[q]``, its f32 z in shared memory (``slice + 4`` floats): the
      fewest CTAs, up to ``cluster_max`` (16, non-portable above 8), whose
      slice keeps to ``share`` (110 KB, two CTAs an SM).  Unlike kernels 3
      and 4, kernel 2 has no partner kernel whose lse it must repeat, so it
      takes the 10 CTAs of 102 KB that gemma-2b's row needs for two CTAs an
      SM: 1.94 -> 1.71 ms in f32 and 1.22 -> 1.00 ms in bf16 against 8 CTAs
      of 128 KB (``tools/kernel_ab.py --ens-plans``, NVIDIA H100 80GB HBM3,
      700 W).

    ``smem`` is a CTA's dynamic shared bytes."""
    if min(M, N, V) < 1 or elt not in (2, 4):
        raise ValueError(f"ensemble_plan: M {M}, N {N}, V {V}, elt {elt}")
    if V <= KD_ROW_MAX_V:
        rows = max(1, min(N, ENS_SMALL_THREADS, ENS_SMALL_THREADS * (16 // elt) // V))
        step = 16 // math.gcd(V * elt, 16)      # rows a block for whole 16-byte groups
        if rows >= step:
            rows -= rows % step
        lanes = min(32, 1 << ((ENS_SMALL_THREADS // rows).bit_length() - 1),
                    1 << (V - 1).bit_length())
        return {"path": "small", "cluster": 1, "slice": V, "slices": [(0, V)], "rows": rows,
                "lanes": lanes, "threads": ENS_SMALL_THREADS, "grid": -(-N // rows),
                "smem": 4 * (rows * V + 4)}
    c, sl, smem = _row_cut(V, lambda sl: 4 * (sl + 4), cluster_max or KD_MAX_CLUSTER,
                           share or KD_CTA_SHARE, f"ensemble_softmax: a row of V = {V}")
    return {"path": "staged", "cluster": c, "slice": sl,
            "slices": [(min(V, q * sl), min(V, q * sl + sl)) for q in range(c)],
            "rows": 1, "lanes": ENS_STAGED_THREADS, "threads": ENS_STAGED_THREADS,
            "grid": N * c, "smem": smem}


def ensemble_plan_args(p: dict) -> tuple:
    """A plan's fields in the C entry's order: path, cluster, slice, rows, lanes, smem."""
    return _ENS_PATHS[p["path"]], p["cluster"], p["slice"], p["rows"], p["lanes"], p["smem"]


@functools.lru_cache(maxsize=256)
def _ensemble_plan_args(M: int, N: int, V: int, elt: int) -> tuple:
    return ensemble_plan_args(ensemble_plan(M, N, V, elt))


# ---------------------------------------------------------------- kd_loss
# Kernels 3 and 4's launch plan (csrc/kd_loss.cu keeps the same constants).
KD_THREAD_ROW_V = 32          # rows path: V up to this, a thread a row, else a warp
KD_ROW_MAX_V = 1024           # V up to this: lanes of one warp a row, s not staged
KD_SMALL_ELEMS = 8192         # B·V up to this (V <= 1024): one CTA, one launch
KD_SMALL_THREADS = 1024       # the small path's CTA and the finish kernel's
KD_ROWS_THREADS = 256
KD_STAGED_THREADS = 512
KD_CTA_SHARE = 110 * 1024     # staged s a CTA: two CTAs share an SM's 228 KB
KD_PORTABLE_CLUSTER = 8
KD_MAX_CLUSTER = 16           # non-portable: only rows that do not fit 8 CTAs
KD_SMEM_MAX = 232448 - 1024   # dynamic shared memory a CTA: 227 KB less static
KD_GROUP = 8                  # slices start on whole 8-element groups
_KD_PATHS = {"small": 0, "rows": 1, "staged": 2}


def _staged_bytes(n: int, elt: int) -> int:
    """Shared bytes of a staged copy of n elements: a 16-byte lead-in keeps
    the source's 16-byte phase (csrc/kd_loss.cu, staged_bytes)."""
    return (n * elt + 16 + 15) // 16 * 16


def _row_cut(V: int, smem_of, cluster_max: int, share: int, what: str) -> tuple:
    """(cluster, slice, smem) of a staged row: slices of whole KD_GROUP
    elements, ``smem_of(slice)`` shared bytes a CTA; the fewest CTAs, up to
    ``cluster_max``, that keep to ``share``, else ``cluster_max`` CTAs if
    their slices fit a CTA, else the fewest up to 16 that fit."""
    def cut(c: int) -> tuple[int, int]:
        sl = -(-(-(-V // c)) // KD_GROUP) * KD_GROUP
        return sl, smem_of(sl)

    fits = [c for c in range(1, cluster_max + 1) if cut(c)[1] <= share]
    if not fits:
        fits = [c for c in [cluster_max, *range(cluster_max + 1, KD_MAX_CLUSTER + 1)]
                if cut(c)[1] <= KD_SMEM_MAX]
    if not fits:
        raise ValueError(f"{what} does not fit {KD_MAX_CLUSTER} CTAs' shared memory")
    return (fits[0], *cut(fits[0]))


def kd_plan(B: int, V: int, elt: int, cluster_max: int = KD_PORTABLE_CLUSTER,
            share: int = KD_CTA_SHARE) -> dict:
    """Kernels 3 and 4's launch for (B, V) rows of ``elt``-byte student logits.

    * ``small`` (V <= 1024, B·V <= 8192): kernel 3 is one CTA that stages
      all of s and t and does every row, ``row_lanes`` lanes a row (as many
      as let the CTA's 1,024 threads hold every row at once, at most 32 and
      V's next power of two), and writes the loss itself; kernel 4 spreads
      the rows over one-warp CTAs with the same lanes a row;
    * ``rows`` (V <= 1024, more rows): a thread (V <= 32) or a warp a row,
      unstaged;
    * ``staged``: a cluster of ``cluster`` CTAs a row, each staging one
      slice of s in shared memory: the fewest CTAs, up to ``cluster_max``,
      whose slice keeps to ``share`` bytes, else ``cluster_max`` CTAs if their
      slices fit a CTA, else the fewest up to 16 that fit.

    ``slices`` are the CTAs' [lo, hi) by rank, ``smem`` a CTA's dynamic
    shared bytes, ``launches_fwd`` kernel 3's launches (a second one sums the
    rows' KL).  Kernel 4 takes the same plan, so it forms each row's lse as
    kernel 3 does."""
    if B < 1 or V < 1:
        raise ValueError(f"kd_plan: B {B}, V {V}")
    if V <= KD_ROW_MAX_V:
        if B * V <= KD_SMALL_ELEMS:
            lanes = min(32, 1 << (max(1, KD_SMALL_THREADS // B).bit_length() - 1),
                        1 << (V - 1).bit_length())
            return {"path": "small", "cluster": 1, "slice": V, "slices": [(0, V)],
                    "threads": KD_SMALL_THREADS, "row_lanes": lanes, "grid": 1,
                    "smem": _staged_bytes(B * V, elt) + _staged_bytes(B * V, 4) + 4 * B,
                    "launches_fwd": 1}
        lanes = 1 if V <= KD_THREAD_ROW_V else 32
        rows = KD_ROWS_THREADS // lanes
        return {"path": "rows", "cluster": 1, "slice": V, "slices": [(0, V)],
                "threads": KD_ROWS_THREADS, "row_lanes": lanes, "grid": -(-B // rows),
                "smem": 0, "launches_fwd": 2}

    c, sl, smem = _row_cut(V, lambda sl: _staged_bytes(sl, elt), cluster_max, share,
                           f"kd_loss: a row of V = {V} ({V * elt} bytes)")
    return {"path": "staged", "cluster": c, "slice": sl,
            "slices": [(min(V, q * sl), min(V, q * sl + sl)) for q in range(c)],
            "threads": KD_STAGED_THREADS, "row_lanes": KD_STAGED_THREADS, "grid": B * c,
            "smem": smem, "launches_fwd": 1 if B == 1 else 2}


@functools.lru_cache(maxsize=256)
def _kd_plan_args(B: int, V: int, elt: int) -> tuple:
    """The plan as the C launchers take it: path, cluster, slice, lanes, smem."""
    return kd_plan_args(kd_plan(B, V, elt))


def kd_plan_args(p: dict) -> tuple:
    """A plan's fields in the C launchers' order."""
    lanes = 0 if p["path"] == "staged" else p["row_lanes"]
    return _KD_PATHS[p["path"]], p["cluster"], p["slice"], lanes, p["smem"]


def _kd_check(name, s, t):
    _check(name, s, "student_logits", _DTYPES)
    _check(name, t, "teacher_probs", (torch.float32,))
    if s.ndim != 2 or s.shape != t.shape or min(s.shape) < 1:
        raise ValueError(f"{name}: student {tuple(s.shape)} and teacher "
                         f"{tuple(t.shape)} must both be (B, V)")


def kd_loss_fwd(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """The loss ``mean_b KL_b · τ²``, a device scalar written by the kernel
    (``kd_plan``: one launch, or a second that sums the rows' KL)."""
    s, t = student_logits, teacher_probs
    if _device("kd_loss_fwd", s, t).type == "cpu":
        return ref.kd_loss_ref(s, t, temperature)
    _kd_check("kd_loss_fwd", s, t)
    B, V = s.shape
    buf = torch.empty((B + 1,), dtype=torch.float32, device=s.device)  # rows' KL, loss
    lib = _lib()
    code = lib.kd_loss_fwd(s.data_ptr(), t.data_ptr(), buf.data_ptr(), B, V,
                           1.0 / temperature, temperature ** 2 / B,
                           *_kd_plan_args(B, V, s.element_size()), _DTYPES[s.dtype],
                           _stream(s.device))
    build.check(lib, code, "kd_loss_fwd")
    kernels.count("kd_loss_fwd", s.device)
    return buf[B]


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
                           *_kd_plan_args(B, V, s.element_size()), _DTYPES[s.dtype],
                           _stream(s.device))
    build.check(lib, code, "kd_loss_bwd")
    kernels.count("kd_loss_bwd", s.device)
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


def ensemble_kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                     temperature: float = 1.0):
    """The whole dense path in one call: a (K, B, V) teacher stack and the
    (B, V) student -> ``kd_loss`` against ``ensemble_softmax``'s probs."""
    return kd_loss(student_logits, ensemble_softmax(teacher_logits.detach(), temperature),
                   temperature)


# =============================================================== Flash-KD
def _flash_lib():
    lib = build.load("flash_kd")
    if lib.flash_kd_fwd.argtypes is None:
        bind_flash(lib)
    return lib


def bind_flash(lib) -> None:
    """Declare the C signatures of ``csrc/flash_kd.cu``."""
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.flash_kd_fwd_chunks.argtypes = [i]
    lib.flash_kd_fwd_chunks.restype = ctypes.c_int
    for name in ("flash_kd_head_fwd_workspace", "flash_kd_head_bwd_workspace"):
        getattr(lib, name).argtypes = [i, i, i]
        getattr(lib, name).restype = ll
    lib.flash_kd_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, f, f, i, i, vp]
    lib.flash_kd_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, f, f, i, i, vp]
    lib.flash_kd_head_fwd.argtypes = [vp, vp, ll, ll, vp, vp, vp, vp, vp, vp, vp,
                                      i, i, i, f, f, i, i, vp]
    lib.flash_kd_head_bwd.argtypes = [vp, vp, ll, ll, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                      i, i, i, f, f, i, i, vp]
    for fn in (lib.flash_kd_fwd, lib.flash_kd_bwd, lib.flash_kd_head_fwd,
               lib.flash_kd_head_bwd):
        fn.restype = ctypes.c_int


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _f32_rows(t: torch.Tensor, B: int, what: str, name: str) -> torch.Tensor:
    t = t.detach().to(torch.float32).contiguous()
    if t.shape != (B,):
        raise ValueError(f"{name}: {what} {tuple(t.shape)}, need ({B},)")
    return t


def _f32_scalar(g: torch.Tensor, name: str) -> torch.Tensor:
    if g.numel() != 1:
        raise ValueError(f"{name}: upstream gradient of shape {tuple(g.shape)}")
    return g.detach().to(torch.float32).contiguous()


def _flash_check(name, s, t):
    _check(name, s, "student_logits", _DTYPES)
    _check(name, t, "teacher_mean_logits", _DTYPES)
    if s.ndim != 2 or s.shape != t.shape or min(s.shape) < 1:
        raise ValueError(f"{name}: student {tuple(s.shape)} and teacher "
                         f"{tuple(t.shape)} must both be (B, V)")


def _head_check(name, h, w, b, t):
    _check(name, h, "features", _DTYPES)
    _check(name, t, "teacher_mean_logits", _DTYPES)
    if w.dtype != h.dtype or (b is not None and b.dtype != h.dtype):
        raise ValueError(f"{name}: the kernel takes features, head and bias in one "
                         f"dtype, got {h.dtype}, {w.dtype}, "
                         f"{None if b is None else b.dtype}")
    if h.ndim != 2 or w.ndim != 2 or t.ndim != 2 or min(h.shape) < 1 or min(t.shape) < 1:
        raise ValueError(f"{name}: features {tuple(h.shape)}, head {tuple(w.shape)}, "
                         f"teacher {tuple(t.shape)}")
    B, D = h.shape
    if w.shape != (D, t.shape[1]) or t.shape[0] != B:
        raise ValueError(f"{name}: features {tuple(h.shape)}, head {tuple(w.shape)} and "
                         f"teacher {tuple(t.shape)} do not make (B, D) @ (D, V) -> (B, V)")
    if not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError(f"{name}: the head must be (D, V) row-major or the transpose of "
                         f"a row-major (V, D) matrix (a tied embedding); got strides "
                         f"{w.stride()}")
    if b is not None:
        _check(name, b, "head_b", _DTYPES)
        if b.shape != (t.shape[1],):
            raise ValueError(f"{name}: head_b {tuple(b.shape)}, need ({t.shape[1]},)")


# ---- the launches, on a given library and stream (CUDA tensors) ----------
def flash_fwd_launch(lib, stream: int, s, t, lse_t, temperature: float):
    """Kernel 7 (and its combine pass): ``(loss, lse_s, lse_t)``."""
    B, V = s.shape
    f32 = dict(dtype=torch.float32, device=s.device)
    part = torch.empty((B, lib.flash_kd_fwd_chunks(V), 5), **f32)
    lse_s, loss = torch.empty((B,), **f32), torch.empty((), **f32)
    lse_t_out = lse_t if lse_t is not None else torch.empty((B,), **f32)
    code = lib.flash_kd_fwd(s.data_ptr(), t.data_ptr(), _ptr(lse_t), part.data_ptr(),
                            lse_s.data_ptr(), lse_t_out.data_ptr(), loss.data_ptr(), B, V,
                            1.0 / temperature, temperature ** 2 / B, _DTYPES[s.dtype],
                            _DTYPES[t.dtype], stream)
    build.check(lib, code, "flash_kd_fwd")
    return loss, lse_s, lse_t_out


def flash_bwd_launch(lib, stream: int, s, t, lse_s, lse_t, g, temperature: float):
    """Kernel 8: the gradient wrt the student logits, in s's dtype."""
    B, V = s.shape
    out = torch.empty_like(s)
    code = lib.flash_kd_bwd(s.data_ptr(), t.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(),
                            g.data_ptr(), out.data_ptr(), B, V, 1.0 / temperature,
                            temperature / B, _DTYPES[s.dtype], _DTYPES[t.dtype], stream)
    build.check(lib, code, "flash_kd_bwd")
    return out


def flash_head_fwd_launch(lib, stream: int, h, w, b, t, lse_t, temperature: float):
    """Kernel 9: ``(loss, lse_s, lse_t)``.  The workspace holds the bf16
    hi/lo planes of h and of one chunk of W, and the online states of each
    (row, 128-column tile) and of each row (``csrc/flash_kd.cu``, k9::plan)."""
    B, D = h.shape
    V = t.shape[1]
    f32 = dict(dtype=torch.float32, device=h.device)
    ws = torch.empty((lib.flash_kd_head_fwd_workspace(B, D, V),), dtype=torch.uint8,
                     device=h.device)
    lse_s, loss = torch.empty((B,), **f32), torch.empty((), **f32)
    lse_t_out = lse_t if lse_t is not None else torch.empty((B,), **f32)
    code = lib.flash_kd_head_fwd(h.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1), _ptr(b),
                                 t.data_ptr(), _ptr(lse_t), lse_s.data_ptr(),
                                 lse_t_out.data_ptr(), loss.data_ptr(), ws.data_ptr(), B, D, V,
                                 1.0 / temperature, temperature ** 2 / B, _DTYPES[h.dtype],
                                 _DTYPES[t.dtype], stream)
    build.check(lib, code, "flash_kd_head_fwd")
    return loss, lse_s, lse_t_out


def flash_head_bwd_launch(lib, stream: int, h, w, b, t, lse_s, lse_t, g, temperature: float):
    """Kernel 10: ``(∂h, ∂W, ∂b)``; ∂W has W's strides, ∂h is summed in f32.
    The workspace holds the bf16 hi/lo planes of h, of one chunk of W and
    of d, and the split partials of ∂h (``csrc/flash_kd.cu``, k10::plan)."""
    B, D = h.shape
    V = t.shape[1]
    gh = torch.empty((B, D), dtype=torch.float32, device=h.device)
    ws = torch.empty((lib.flash_kd_head_bwd_workspace(B, D, V),), dtype=torch.uint8,
                     device=h.device)
    gw = torch.empty_strided(tuple(w.shape), w.stride(), dtype=w.dtype, device=w.device)
    gb = None if b is None else torch.empty_like(b)
    code = lib.flash_kd_head_bwd(h.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1), _ptr(b),
                                 t.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(), g.data_ptr(),
                                 gh.data_ptr(), gw.data_ptr(), _ptr(gb), ws.data_ptr(), B, D,
                                 V, 1.0 / temperature, temperature / B, _DTYPES[h.dtype],
                                 _DTYPES[t.dtype], stream)
    build.check(lib, code, "flash_kd_head_bwd")
    return gh.to(h.dtype), gw, gb


# ---- the wrappers: CPU tensors take the plain versions ------------------
def flash_kd_fwd(student_logits, teacher_mean_logits, temperature: float = 1.0,
                 tile_v: int | None = None, teacher_lse=None):
    """Streaming fused KD forward (kernel 7): ``(loss, lse_s, lse_t)``, the
    loss a device scalar and the normalisers of z/τ per row."""
    s, t = student_logits.detach(), teacher_mean_logits.detach()
    on = (s, t) if teacher_lse is None else (s, t, teacher_lse)
    if _device("flash_kd_fwd", *on).type == "cpu":
        return flash.flash_kd_fwd_tiled(s, t, temperature, tile_v or flash.DEFAULT_TILE_V_HOST,
                                        teacher_lse=teacher_lse)
    _flash_check("flash_kd_fwd", s, t)
    lse_t = None if teacher_lse is None else _f32_rows(teacher_lse, s.shape[0],
                                                       "teacher_lse", "flash_kd_fwd")
    out = flash_fwd_launch(_flash_lib(), _stream(s.device), s, t, lse_t, float(temperature))
    kernels.count("flash_kd_fwd", s.device)
    return out


def flash_kd_bwd(student_logits, teacher_mean_logits, lse_s, lse_t, g,
                 temperature: float = 1.0):
    """∂(g·loss)/∂student_logits = g·(τ/B)·(e^{s − lse_s} − e^{t − lse_t}) in
    the student's dtype (kernel 8); ``g`` is read on the device."""
    s, t = student_logits.detach(), teacher_mean_logits.detach()
    if _device("flash_kd_bwd", s, t, lse_s, lse_t, g).type == "cpu":
        return flash.flash_kd_bwd_ref(s, t, lse_s, lse_t, g, temperature)
    _flash_check("flash_kd_bwd", s, t)
    B = s.shape[0]
    out = flash_bwd_launch(_flash_lib(), _stream(s.device), s, t,
                           _f32_rows(lse_s, B, "lse_s", "flash_kd_bwd"),
                           _f32_rows(lse_t, B, "lse_t", "flash_kd_bwd"),
                           _f32_scalar(g, "flash_kd_bwd"), float(temperature))
    kernels.count("flash_kd_bwd", s.device)
    return out


def flash_kd_head_fwd(features, head_w, head_b, teacher_mean_logits,
                      temperature: float = 1.0, tile_v: int | None = None, teacher_lse=None):
    """Head-fused streaming KD forward (kernel 9): ``(loss, lse_s, lse_t)``
    with the student tile ``h @ W[:, tile] (+ b)`` formed in the kernel."""
    h, w, t = features.detach(), head_w.detach(), teacher_mean_logits.detach()
    b = None if head_b is None else head_b.detach()
    on = [x for x in (h, w, b, t, teacher_lse) if x is not None]
    if _device("flash_kd_head_fwd", *on).type == "cpu":
        return flash.flash_kd_head_fwd_tiled(h, w, b, t, temperature,
                                             tile_v or flash.DEFAULT_TILE_V_HOST,
                                             teacher_lse=teacher_lse)
    _head_check("flash_kd_head_fwd", h, w, b, t)
    lse_t = None if teacher_lse is None else _f32_rows(teacher_lse, h.shape[0],
                                                       "teacher_lse", "flash_kd_head_fwd")
    out = flash_head_fwd_launch(_flash_lib(), _stream(h.device), h, w, b, t, lse_t,
                                float(temperature))
    kernels.count("flash_kd_head_fwd", h.device)
    return out


def flash_kd_head_bwd(features, head_w, head_b, teacher_mean_logits, lse_s, lse_t, g,
                      temperature: float = 1.0, tile_v: int | None = None):
    """Head-fused backward (kernel 10): ``(∂h, ∂W, ∂b)`` from the saved
    normalisers; ∂W in the head's own layout and dtype, ∂b None without a
    bias."""
    h, w, t = features.detach(), head_w.detach(), teacher_mean_logits.detach()
    b = None if head_b is None else head_b.detach()
    on = [x for x in (h, w, b, t, lse_s, lse_t, g) if x is not None]
    if _device("flash_kd_head_bwd", *on).type == "cpu":
        return flash.flash_kd_head_bwd_tiled(h, w, b, t, lse_s, lse_t, g, temperature,
                                             tile_v or flash.DEFAULT_TILE_V_HOST)
    _head_check("flash_kd_head_bwd", h, w, b, t)
    B = h.shape[0]
    out = flash_head_bwd_launch(_flash_lib(), _stream(h.device), h, w, b, t,
                                _f32_rows(lse_s, B, "lse_s", "flash_kd_head_bwd"),
                                _f32_rows(lse_t, B, "lse_t", "flash_kd_head_bwd"),
                                _f32_scalar(g, "flash_kd_head_bwd"), float(temperature))
    kernels.count("flash_kd_head_bwd", h.device)
    return out


# ---- the losses ----------------------------------------------------------
class _FlashKDLoss(torch.autograd.Function):
    """The reference's ``custom_vjp`` of ``_flash_kd_loss``: the backward
    needs only the saved normalisers, no recompute of either softmax."""

    @staticmethod
    def forward(ctx, student_logits, teacher_mean_logits, teacher_lse, temperature, tile_v):
        loss, lse_s, lse_t = flash_kd_fwd(student_logits, teacher_mean_logits, temperature,
                                          tile_v, teacher_lse=teacher_lse)
        ctx.save_for_backward(student_logits, teacher_mean_logits, lse_s, lse_t)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        s, zt, lse_s, lse_t = ctx.saved_tensors
        return flash_kd_bwd(s, zt, lse_s, lse_t, g, ctx.temperature), None, None, None, None


def flash_kd_loss(student_logits, teacher_mean_logits, temperature: float = 1.0,
                  tile_v: int | None = None, teacher_lse=None):
    """Fused vocab-tiled KD loss from the compressed teacher cache: equals
    ``kd_loss(s, softmax(z̄/τ), τ)`` up to f32 summation order.  The mean
    teacher logit row ``z̄`` may be bf16; ``teacher_lse`` (logsumexp(z̄/τ),
    computed once at cache build) skips the teacher's online max/sum.
    Differentiable in the student logits only (teachers frozen, Eq. 4)."""
    return _FlashKDLoss.apply(student_logits, teacher_mean_logits.detach(),
                              None if teacher_lse is None else teacher_lse.detach(),
                              float(temperature), tile_v)


class _FlashKDHeadLoss(torch.autograd.Function):
    """The reference's ``custom_vjp`` of ``_flash_kd_head_loss``."""

    @staticmethod
    def forward(ctx, features, head_w, head_b, teacher_mean_logits, teacher_lse, temperature,
                tile_v):
        loss, lse_s, lse_t = flash_kd_head_fwd(features, head_w, head_b, teacher_mean_logits,
                                               temperature, tile_v, teacher_lse=teacher_lse)
        ctx.save_for_backward(features, head_w, head_b, teacher_mean_logits, lse_s, lse_t)
        ctx.temperature, ctx.tile_v = temperature, tile_v
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, b, zt, lse_s, lse_t = ctx.saved_tensors
        gh, gw, gb = flash_kd_head_bwd(h, w, b, zt, lse_s, lse_t, g, ctx.temperature,
                                       ctx.tile_v)
        return gh, gw, gb, None, None, None, None


def flash_kd_head_loss(features, head_w, head_b=None, teacher_mean_logits=None,
                       temperature: float = 1.0, tile_v: int | None = None, teacher_lse=None):
    """Head-fused vocab-tiled KD loss: the student LM-head product runs
    inside the streaming V sweep, so the (B, V) student row never exists.

    ``features`` (B, D) are the post-final-norm activations, ``head_w`` the
    (D, V) head (a tied embedding's transpose is used in place), ``head_b``
    an optional (V,) bias.  Differentiable in all three; equals
    ``flash_kd_loss(h @ W + b, z̄, τ)`` up to f32 summation order."""
    if teacher_mean_logits is None:
        # the bias slot precedes the teacher operand: catch the classic
        # off-by-one-argument misuse here instead of deep inside the kernel
        raise TypeError(
            "flash_kd_head_loss needs teacher_mean_logits; got None — "
            "did you skip the head_b slot? Pass head_b=None explicitly: "
            "flash_kd_head_loss(h, W, None, teacher_mean_logits, ...)")
    return _FlashKDHeadLoss.apply(features, head_w, head_b, teacher_mean_logits.detach(),
                                  None if teacher_lse is None else teacher_lse.detach(),
                                  float(temperature), tile_v)


def teacher_cache_lse(mean_logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Per-row logsumexp(z̄/τ) of a (…, V) mean-logit cache, in f32: the
    normaliser stored beside the compressed cache, computed from the
    STORED (possibly bf16-rounded) values so it is exact for what the
    per-step kernel reads."""
    return torch.logsumexp(mean_logits.float() / temperature, dim=-1)
