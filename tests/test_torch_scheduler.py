"""The port's round-time simulator (``repro_torch/core/scheduler.py``)
against the JAX package's: pure Python on both sides, so every number is
equal exactly, on the workloads of ``tests/test_scheduler.py`` and a sweep.
The reference's own assertions (paper Table 3's structure, the Fig. 2
example, the overlap accounting) are mirrored on the port's functions.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.core import scheduler as ref  # noqa: E402
from repro_torch.core import scheduler as port  # noqa: E402
from repro_torch.core.scheduler import (Workload, overlap_summary,  # noqa: E402
                                        round_time_comparison, simulate)

WORKLOADS = [
    dict(rounds=4, K=1, clients_per_round=4, local_train_time=10.0, kd_time=8.0,
         concurrent_clients=1, kd_blocks_all=True),
    dict(rounds=4, K=4, clients_per_round=4, local_train_time=10.0, kd_time=8.0,
         concurrent_clients=1, kd_blocks_all=False),
    dict(rounds=3, K=1, clients_per_round=4, local_train_time=5.0, kd_time=0.0,
         concurrent_clients=2),
    dict(rounds=2, K=1, clients_per_round=2, local_train_time=5.0, kd_time=3.0,
         concurrent_clients=2, kd_precompute_time=2.0),
    dict(rounds=2, K=2, clients_per_round=4, local_train_time=1.0, kd_time=1.0,
         concurrent_clients=4),
    *[dict(rounds=r, K=k, clients_per_round=c, local_train_time=lt, kd_time=kd,
           concurrent_clients=cc, kd_blocks_all=blocks, kd_precompute_time=pre)
      for r, k, c, lt, kd, cc, blocks, pre in itertools.product(
          (1, 5), (1, 3, 4), (4, 7, 20), (2.45, 100.0), (0.0, 4.71), (1, 3, 20),
          (True, False), (0.0, 0.3))],
]


@pytest.mark.parametrize("w", WORKLOADS[:5], ids=lambda w: "-".join(map(str, w.values())))
def test_simulate_equals_reference(w):
    got, want = simulate(Workload(**w)), ref.simulate(ref.Workload(**w))
    assert got.makespan == want.makespan
    assert got.events == want.events
    assert Workload(**w).kd_total == ref.Workload(**w).kd_total


def test_simulate_equals_reference_over_a_sweep():
    for w in WORKLOADS[5:]:
        got, want = simulate(Workload(**w)), ref.simulate(ref.Workload(**w))
        assert (got.makespan, got.events) == (want.makespan, want.events), w


@pytest.mark.parametrize("args", [(10.0, 8.0, 10.0), (10.0, 8.0, 18.0), (10.0, 8.0, 14.0),
                                  (2.45, 4.71, 6.3), (0.0, 0.0, 1.0), (4.62, 2.34, 4.8)])
def test_overlap_summary_equals_reference(args):
    assert overlap_summary(*args) == ref.overlap_summary(*args)


@pytest.mark.parametrize("kw", [
    dict(num_clients=8), dict(num_clients=20, K=4, rounds=6, concurrent_clients=20),
    dict(num_clients=4, K=4, local_train_time=10.0, kd_time_per_member=8.0, rounds=4,
         concurrent_clients=1, kd_pipeline_speedup=4.0),
    dict(num_clients=14, K=2, kd_pipeline_speedup=2.5, kd_precompute_share=0.4)])
def test_round_time_comparison_equals_reference(kw):
    assert round_time_comparison(**kw) == ref.round_time_comparison(**kw)


def test_the_port_is_a_copy_with_no_jax():
    src = open(port.__file__).read()
    assert "import jax" not in src and "repro." not in src.replace("repro_torch", "")
    assert [f.name for f in dataclasses.fields(Workload)] == \
        [f.name for f in dataclasses.fields(ref.Workload)]


# ---------------------------------- the reference's assertions, on the port
def test_feddf_kd_grows_with_clients_fedsdd_flat():
    overheads = {}
    for C in (8, 14, 20):
        r = round_time_comparison(C, K=4, local_train_time=100, kd_time_per_member=10,
                                  rounds=6, concurrent_clients=C)
        overheads[C] = (r["feddf"] - r["fedavg"], r["fedsdd"] - r["fedavg"])
    feddf = [overheads[c][0] for c in (8, 14, 20)]
    fedsdd = [overheads[c][1] for c in (8, 14, 20)]
    assert feddf[0] < feddf[1] < feddf[2]
    assert max(fedsdd) - min(fedsdd) < 1e-6
    assert all(s < f for s, f in zip(fedsdd, feddf))


def test_fig2_parallelism_hides_kd():
    base = dict(rounds=4, clients_per_round=4, local_train_time=10.0, kd_time=8.0,
                concurrent_clients=1)
    feddf = simulate(Workload(K=1, kd_blocks_all=True, **base))
    fedsdd = simulate(Workload(K=4, kd_blocks_all=False, **base))
    assert fedsdd.makespan < feddf.makespan


def test_zero_kd_equals_fedavg():
    t = simulate(Workload(rounds=3, K=1, clients_per_round=4, local_train_time=5.0,
                          kd_time=0.0, concurrent_clients=2))
    assert abs(t.makespan - 3 * 2 * 5.0) < 1e-6


def test_kd_pipeline_term_shortens_fedsdd_round():
    r = round_time_comparison(4, K=4, local_train_time=10.0, kd_time_per_member=8.0,
                              rounds=4, concurrent_clients=1, kd_pipeline_speedup=4.0)
    assert "fedsdd_fused" in r
    assert r["fedavg"] <= r["fedsdd_fused"] <= r["fedsdd"]
    assert "fedsdd_fused" not in round_time_comparison(4)


def test_kd_precompute_extends_kd_job():
    base = dict(rounds=2, K=1, clients_per_round=2, local_train_time=5.0, kd_time=3.0,
                concurrent_clients=2)
    plain = simulate(Workload(**base))
    with_pre = simulate(Workload(**base, kd_precompute_time=2.0))
    assert with_pre.makespan == plain.makespan + 2 * 2.0


def test_overlap_summary_bounds():
    ideal = overlap_summary(10.0, 8.0, 10.0)
    assert ideal["ratio_vs_ideal"] == pytest.approx(1.0)
    assert ideal["hidden_fraction"] == pytest.approx(1.0)
    serial = overlap_summary(10.0, 8.0, 18.0)
    assert serial["ratio_vs_ideal"] == pytest.approx(1.8)
    assert serial["hidden_fraction"] == pytest.approx(0.0)
    half = overlap_summary(10.0, 8.0, 14.0)
    assert half["hidden_fraction"] == pytest.approx(0.5)
    assert half["serial"] == 18.0 and half["ideal"] == 10.0


def test_trace_events_cover_all_jobs():
    t = simulate(Workload(rounds=2, K=2, clients_per_round=4, local_train_time=1.0,
                          kd_time=1.0, concurrent_clients=4))
    assert len([e for e in t.events if "/c" in e[2]]) == 2 * 4
    assert len([e for e in t.events if e[2].endswith("KD")]) == 2
