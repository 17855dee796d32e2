"""Roofline model for the target card, an NVIDIA H100 SXM (port of
``repro/utils/hlo.py``, whose constants are the TPU's).

The three-term bound: the FLOPs over the card's peak rate for their type,
the bytes over HBM's rate, and the bytes between cards over NVLink's.  The
HLO passes that the reference re-exports from here (collective bytes,
duplicate fusions, the liveness walk) are ``repro_torch.analysis.passes``'
where the port has them; this module re-exports those with a
:class:`DeprecationWarning`, as the reference does.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

_MOVED = ("live_intermediate_shapes",)


def __getattr__(name: str):
    if name in _MOVED:
        warnings.warn(
            f"repro_torch.utils.hlo.{name} moved to repro_torch.analysis.passes; "
            "import it from repro_torch.analysis instead",
            DeprecationWarning, stacklevel=2)
        from repro_torch.analysis import passes
        return getattr(passes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass(frozen=True)
class H100Spec:
    """Roofline constants of the H100 SXM (NVIDIA's data sheet)."""
    peak_flops_bf16: float = 989e12      # FLOP/s, tensor cores, dense
    peak_flops_f32: float = 67e12        # FLOP/s, CUDA cores (no TF32)
    hbm_bandwidth: float = 3.35e12       # B/s, HBM3
    nvlink_bandwidth: float = 450e9      # B/s per direction (900 GB/s both ways)
    hbm_bytes: float = 80e9

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        """The peak rate for operations on ``dtype`` ("bfloat16" on the
        tensor cores, "float32" on the CUDA cores)."""
        rates = {"bfloat16": self.peak_flops_bf16, "float32": self.peak_flops_f32}
        if dtype not in rates:
            raise ValueError(f"dtype={dtype!r} not in {tuple(rates)}")
        return rates[dtype]


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             chips: int, spec: H100Spec | None = None,
             dtype: str = "bfloat16") -> RooflineTerms:
    """Three-term roofline: ``flops`` on ``dtype`` at the spec's peak rate
    for it, ``hbm_bytes`` over HBM, ``collective_bytes`` over NVLink, each
    spread over ``chips`` cards (pass per-card numbers with chips=1)."""
    if spec is None:
        spec = H100Spec()
    return RooflineTerms(
        compute_s=flops / (chips * spec.peak_flops(dtype)),
        memory_s=hbm_bytes / (chips * spec.hbm_bandwidth),
        collective_s=collective_bytes / (chips * spec.nvlink_bandwidth),
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        chips=chips,
    )
