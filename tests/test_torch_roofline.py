"""The port's roofline (``repro_torch.utils.hlo``) against the reference's
(``repro.utils.hlo``), and ``chip_smoke.py``'s bounds through it.

With the TPU's constants passed as the spec, the port's three terms equal
the reference's on the reference's own cases; the H100's constants are its
data sheet's; and every bound ``chip_smoke.py`` prints is the same number
as before its bounds came from ``roofline`` (the formula it replaced, with
the constants it held: 3.35e12 B/s, 67e12 and 989e12 FLOP/s).
"""
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.utils.hlo import TPUv5eSpec  # noqa: E402
from repro.utils.hlo import roofline as ref_roofline  # noqa: E402
from repro_torch.utils.hlo import H100Spec, roofline  # noqa: E402

FIELDS = ("compute_s", "memory_s", "collective_s", "flops", "hbm_bytes", "collective_bytes",
          "chips")


def _tpu_as_spec() -> H100Spec:
    ref = TPUv5eSpec()
    return H100Spec(peak_flops_bf16=ref.peak_flops_bf16, hbm_bandwidth=ref.hbm_bandwidth,
                    nvlink_bandwidth=ref.ici_bandwidth, hbm_bytes=ref.hbm_bytes)


# the reference's test_roofline_terms_and_dominance cases
CASES = [(197e12, 0, 0, 1, "compute"), (0, 819e9, 1, 1, "memory"),
         (1, 1, 50e9, 1, "collective"), (197e12, 819e9, 50e9, 4, None),
         (3e15, 2e12, 7e9, 2, None)]


@pytest.mark.parametrize("flops,nbytes,coll,chips,dominant", CASES)
def test_terms_equal_the_reference_under_its_constants(flops, nbytes, coll, chips, dominant):
    got = roofline(flops, nbytes, coll, chips, spec=_tpu_as_spec())
    ref = ref_roofline(flops, nbytes, coll, chips, spec=TPUv5eSpec())
    assert [getattr(got, f) for f in FIELDS] == [getattr(ref, f) for f in FIELDS]
    assert got.dominant == ref.dominant and got.bound_s == ref.bound_s
    if dominant is not None:
        assert got.dominant == dominant
        assert abs(getattr(got, f"{dominant}_s") - 1.0) < 1e-9


def test_chips_scale_all_terms_down():
    t = roofline(197e12, 819e9, 50e9, chips=4, spec=_tpu_as_spec())
    assert abs(t.compute_s - 0.25) < 1e-9 and abs(t.memory_s - 0.25) < 1e-9
    assert abs(t.collective_s - 0.25) < 1e-9


def test_h100_defaults():
    spec = H100Spec()
    assert (spec.peak_flops_bf16, spec.peak_flops_f32, spec.hbm_bandwidth,
            spec.nvlink_bandwidth, spec.hbm_bytes) == (989e12, 67e12, 3.35e12, 450e9, 80e9)
    t = roofline(989e12, 3.35e12, 450e9, 1)               # the default spec is the H100's
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    assert roofline(67e12, 0, 0, 1, dtype="float32").compute_s == 1.0
    assert roofline(67e12, 0, 0, 1, dtype="float32").dominant == "compute"
    with pytest.raises(ValueError, match="dtype"):
        roofline(1, 1, 1, 1, dtype="float16")


def test_moved_names_warn_and_unknown_names_raise():
    import repro_torch.utils.hlo as hlo
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn = hlo.live_intermediate_shapes
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    from repro_torch.analysis import live_intermediate_shapes
    assert fn is live_intermediate_shapes
    with pytest.raises(AttributeError):
        _ = hlo.no_such_name


def _old_bound(nbytes, ops, peak):
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


BOUND_CASES = [(0, 0), (1, 1), (8 * 152064 * 4, 10 * 8 * 152064), (2 ** 40 + 3, 7 * 2 ** 41 + 1),
               (3.35e9, 989e9), (67e9, 3.35e9), (512 * 256000 * 6, 6 * 512 * 2048 * 256000)]


@pytest.mark.parametrize("nbytes,ops", BOUND_CASES)
def test_chip_smoke_bounds_unchanged(nbytes, ops, monkeypatch):
    root = Path(__file__).resolve().parent.parent
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke as cs
    cs.use_h100_spec()
    assert cs.HBM_BYTES_PER_S == 3.35e12
    assert cs.PEAK_FLOPS == {torch.float32: 67e12, torch.bfloat16: 989e12}
    assert cs._bound(nbytes, ops) == _old_bound(nbytes, ops, 67e12)
    assert cs._bound(nbytes, ops, torch.bfloat16) == _old_bound(nbytes, ops, 989e12)
    assert cs.wa_bound(4, 2, 855578, 4) == _old_bound(
        4 * 2 * 855578 * 4 + 4 * 2 * 4 + 4 * 855578 * 4, 2 * 4 * 2 * 855578, 67e12)
