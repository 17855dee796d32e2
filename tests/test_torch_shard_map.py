"""The client axis over ``torch.distributed`` (``launch/mesh.py``, the
vectorized engine's ``prepare_bucket`` / ``finish_bucket`` and the KD
pipeline's sharded teacher pass), against the port's own ``"vmap"`` runs
and the JAX package's vectorized runner under ``client_sharding="vmap"``.
The reference's own forced-``shard_map`` oracle cannot serve: on JAX 0.9 it
fails in ``distill/teacher_bank.py`` with a ``ShardingTypeError``, and it
asserts itself that ``shard_map`` is a refactoring of vmap.

  (a) One rank, no process group: ``client_sharding="shard_map"``, and
      ``REPRO_FORCE_SHARD_MAP=1`` under ``"auto"``, give ``"vmap"``'s
      models k>0 bit for bit and the main model within 2e-4, under
      ``overlap`` off, async and fused (the paired programs under
      ``REPRO_ENGINE_STEP_MODE=scan``).
  (b) Four gloo ranks, spawned, joined through a ``FileStore``: a CNN
      FedSDD run (K=3, R=2) whose one bucket holds 6 clients (2 rows a
      rank, 2 of them padding) and whose ring holds 3 then 6 teachers
      (padded to 4 and 8), dense, flash and with trust weights.  After
      each of 2 rounds every rank's K models are equal bit for bit, and
      within 2e-4 of the JAX runner's.
  (c) ``collective_stats()`` on the four ranks: the teacher all-reduce
      moves nB·B·V·4 bytes for M = 2, 6 and 8 (not a function of M: the
      paper's scalability claim), its cache equals the unsharded pass's;
      the engine's all-gather moves the padded stack's bytes, once a
      dtype.
  (d) The training CLI under ``torch.distributed.run`` with two gloo ranks
      exits 0, prints one history, and leaves one set of checkpoints and
      one spill directory a rank.

Every spawned run joins within ``JOIN_S`` or fails the test.  JAX is
imported inside the fixtures only: the spawned ranks import this module.
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

ATOL = RTOL = 2e-4
JOIN_S = 120
WORLD = 4
# every shard holds at least client_batch examples: one bucket of 6 clients
SPEC = dict(model="cnn", num_clients=6, alpha=1.0, num_train=400, num_server=256, seed=0)
RUN = dict(K=3, R=2, num_clients=6, participation=1.0, local_epochs=1, client_lr=0.05,
           server_lr=0.05, distill_steps=3, client_batch=32, execution="vectorized")
CONFIGS = {"dense": dict(), "flash": dict(kd_kernel="flash"),
           "trust": dict(teacher_trust=True)}
ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module, as in the spawned ranks: the
    same arithmetic, and much faster where several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task():
    return classification_task(**SPEC, device="cpu")


def _state(runner, init):
    return FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                    ensemble=TeacherBank(runner.cfg.K, runner.cfg.R))


def _sorted_leaves(tree) -> list:
    """A tree's leaves with dict keys in sorted order, as ``jax.tree.leaves``
    walks them (the port's own walkers keep insertion order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _leaves_np(models) -> list:
    return [x.detach().numpy().copy() for m in models for x in _sorted_leaves(m)]


# ------------------------------------------------------------------- (a)
@pytest.fixture(scope="module")
def one_rank():
    """The task, the initial models and the ``"vmap"`` runs by overlap
    (each made once, by the first case that needs it)."""
    task = _task()
    init = make_runner("fedsdd", task, device="cpu", **RUN).init_state().global_models
    return task, init, {}


def _run(task, init, overlap, **kw):
    runner = make_runner("fedsdd", task, device="cpu", overlap=overlap, **RUN, **kw)
    state = runner.finalize(runner.run(ROUNDS, state=_state(runner, init)))
    return runner, state


@pytest.mark.parametrize("overlap", ["off", "async", "fused"])
@pytest.mark.parametrize("how", ["shard_map", "forced"])
def test_one_rank_shard_map_is_vmap(one_rank, overlap, how, monkeypatch):
    task, init, vmap_runs = one_rank
    if overlap == "fused":
        monkeypatch.setenv("REPRO_ENGINE_STEP_MODE", "scan")
    if overlap not in vmap_runs:
        vmap_runs[overlap] = _run(task, init, overlap, client_sharding="vmap")[1]
    want = vmap_runs[overlap]
    if how == "forced":
        monkeypatch.setenv("REPRO_FORCE_SHARD_MAP", "1")
    runner, got = _run(task, init, overlap,
                       client_sharding="shard_map" if how == "shard_map" else "auto")
    assert runner._make_engine()._use_shard_map() and runner._kd_pipeline()._shard_teachers()
    assert runner._make_engine().mesh.size == 1 and runner._make_engine().mesh.group is None
    for k in range(1, RUN["K"]):
        for a, b in zip(tree_leaves(got.global_models[k]), tree_leaves(want.global_models[k])):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got.global_models[0]), tree_leaves(want.global_models[0])):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    assert [r.get("kd_loss_last") for r in got.history] == pytest.approx(
        [r.get("kd_loss_last") for r in want.history], abs=ATOL)


# ------------------------------------------------------------- (b), (c)
def _linear_logits(p, b):
    return b["x"] @ p["w"]


def _collectives_part(rank: int, out: dict) -> None:
    """(c) on this rank: the teacher all-reduce's bytes for several M, and
    the engine's all-gather bytes for a padded bucket."""
    from repro_torch.analysis import collective_stats
    from repro_torch.core import engine
    from repro_torch.core.fedsdd import make_config
    from repro_torch.core.grouping import assign_groups, sample_clients
    from repro_torch.distill import KDPipeline
    from repro_torch.launch.mesh import make_client_mesh
    gen = torch.Generator().manual_seed(7)
    nB, B, D, V = 3, 8, 6, 40
    batches = [{"x": torch.randn(B, D, generator=gen)} for _ in range(nB)]
    teacher = {}
    for M in (2, 6, 8):
        teachers = [{"w": torch.randn(D, V, generator=gen)} for _ in range(M)]
        for kd in ("dense", "flash"):
            kw = dict(steps=1, lr=0.1, temperature=3.0, device="cpu", kd_kernel=kd,
                      cache_dtype="float32" if kd == "flash" else None)
            plain = KDPipeline(_linear_logits, teacher_sharding="vmap", **kw)
            sharded = KDPipeline(_linear_logits, mesh=make_client_mesh(),
                                 teacher_sharding="auto", **kw)
            sb = plain.batches_for(batches)
            want = plain.precompute_cache(teachers, sb)
            with collective_stats() as cs:
                got = sharded.precompute_cache(teachers, sb)
            err = max(float((a - b).abs().max()) for a, b in
                      zip(tree_leaves(got), tree_leaves(want)))
            teacher[f"{kd} M={M}"] = {"bytes": cs.bytes_by_kind, "count": cs.count_by_kind,
                                      "err": err, "expect_bytes": nB * B * V * 4,
                                      "cache": [x.numpy().tolist() for x in tree_leaves(got)]}
    out["teacher"] = teacher

    task = _task()
    cfg = make_config("fedsdd", **RUN)
    rng = np.random.default_rng(3)
    groups = assign_groups(sample_clients(cfg.num_clients, cfg.participation, rng), cfg.K, rng)
    rplan = engine.build_round_plan(task, cfg, groups, rng)
    runner = make_runner("fedsdd", task, device="cpu", **RUN)
    eng = runner._make_engine()
    assert len(rplan.plans) == 1
    plan = rplan.plans[0]
    gid = torch.from_numpy(plan.group_of)
    stacked = tree_map(lambda x: torch.stack([x] * cfg.K), runner.init_state().global_models[0])
    w0 = tree_map(lambda x: x[gid], stacked)
    with collective_stats() as cs:
        p, s, losses = eng.train_bucket(plan, w0, eng.optimizer.init(w0))
    C, rows = len(plan.cids), -(-len(plan.cids) // WORLD)
    row_bytes = sum(x[0].numel() * x.element_size() for x in tree_leaves((p, s, losses))
                    if isinstance(x, torch.Tensor) and x.ndim >= 1)
    out["engine"] = {"bytes": cs.bytes_by_kind, "count": cs.count_by_kind, "C": C,
                     "rows": losses.shape[0], "padded_rows": rows * WORLD,
                     "expect_bytes": rows * WORLD * row_bytes,
                     "dtypes": len({x.dtype for x in tree_leaves((p, s, losses))
                                    if isinstance(x, torch.Tensor) and x.ndim >= 1}),
                     "params": [x.numpy().tolist() for x in tree_leaves(p)]}


def _rank_main(rank: int, store: str, out_dir: str, init_np: list) -> None:
    """One of the four ranks: the (b) runs, round by round, then (c)."""
    import json

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.analysis import collective_stats
        task = _task()
        init = [interop.params_from_numpy(m, device="cpu") for m in init_np]
        stats = {}
        for name, kw in CONFIGS.items():
            runner = make_runner("fedsdd", task, device="cpu", **RUN, **kw)
            assert runner._make_engine()._use_shard_map() and runner._make_engine().mesh.size == WORLD
            state = _state(runner, init)
            for t in range(1, ROUNDS + 1):
                with collective_stats() as cs:
                    state = runner.run_round(state)
                stats[f"{name} r{t}"] = {"bytes": cs.bytes_by_kind, "count": cs.count_by_kind,
                                         "teachers": state.ensemble.num_members}
                np.savez(os.path.join(out_dir, f"{name}_r{t}_rank{rank}.npz"),
                         *_leaves_np(state.global_models))
        out = {"rounds": stats}
        _collectives_part(rank, out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _join(ctx, deadline: float) -> None:
    """Join every spawned process by ``deadline``; a hang fails the test."""
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the spawned ranks did not finish within {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Spawn the four ranks, run the JAX runner meanwhile; returns the
    ranks' output directory and the JAX models after each round."""
    import jax

    from repro.core.fedsdd import make_runner as jax_make_runner
    from repro.core.tasks import classification_task as jax_classification_task
    out_dir = tmp_path_factory.mktemp("ranks")
    jtask = jax_classification_task(**SPEC)
    key = jax.random.PRNGKey(0)
    init_np = [jax.tree.map(np.asarray, jtask.init_fn(k))
               for k in jax.random.split(key, RUN["K"])]
    deadline = time.monotonic() + JOIN_S
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out_dir / "store"), str(out_dir), init_np), nprocs=WORLD,
        join=False, start_method="spawn")
    try:
        jax_models = {}
        for name, kw in CONFIGS.items():
            jrunner = jax_make_runner("fedsdd", jtask, client_sharding="vmap", **RUN, **kw)
            jstate = jrunner.init_state()
            for t in range(1, ROUNDS + 1):
                jstate = jrunner.run_round(jstate)
                jax_models[name, t] = [np.asarray(x) for m in jstate.global_models
                                       for x in jax.tree.leaves(m)]
    finally:
        _join(ctx, deadline)
    return out_dir, jax_models


def _rank_models(out_dir, name, t) -> list:
    out = []
    for r in range(WORLD):
        with np.load(out_dir / f"{name}_r{t}_rank{r}.npz") as z:
            out.append([z[f"arr_{i}"] for i in range(len(z.files))])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_four_ranks_agree_and_match_jax(four_ranks, name):
    out_dir, jax_models = four_ranks
    for t in range(1, ROUNDS + 1):
        ranks = _rank_models(out_dir, name, t)
        for other in ranks[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(ranks[0], other)), (name, t)
        assert len(ranks[0]) == len(jax_models[name, t])
        for a, b in zip(ranks[0], jax_models[name, t]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def _rank_json(out_dir) -> list:
    import json
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_four_ranks_collectives_per_round(four_ranks):
    """A round's collectives: one all-reduce of the server set's logit sum
    (256 × 10 × 4 bytes) and the engine's all-gathers; the ring holds 3
    then 6 teachers, so the all-reduce's bytes do not follow M."""
    out_dir, _ = four_ranks
    stats = _rank_json(out_dir)
    for name in CONFIGS:
        for t in (1, 2):
            rec = stats[0]["rounds"][f"{name} r{t}"]
            assert rec["teachers"] == 3 * t
            assert rec["count"]["all-reduce"] == 1
            assert rec["bytes"]["all-reduce"] == 256 * 10 * 4
            assert rec["count"]["all-gather"] >= 1
            assert all(s["rounds"][f"{name} r{t}"] == rec for s in stats)


def test_teacher_all_reduce_bytes_do_not_depend_on_m(four_ranks):
    out_dir, _ = four_ranks
    stats = _rank_json(out_dir)
    for key, rec in stats[0]["teacher"].items():
        assert rec["count"] == {"all-reduce": 1}, key
        assert rec["bytes"] == {"all-reduce": rec["expect_bytes"]}, key
        assert rec["err"] <= 1e-5, key
        assert all(s["teacher"][key]["cache"] == rec["cache"] for s in stats), key
    assert len({rec["expect_bytes"] for rec in stats[0]["teacher"].values()}) == 1


def test_engine_all_gather_moves_the_padded_stack(four_ranks):
    out_dir, _ = four_ranks
    stats = _rank_json(out_dir)
    rec = stats[0]["engine"]
    assert rec["C"] == 6 and rec["rows"] == 6 and rec["padded_rows"] == 8
    assert rec["count"] == {"all-gather": rec["dtypes"]}
    assert rec["bytes"] == {"all-gather": rec["expect_bytes"]}
    assert all(s["engine"]["params"] == rec["params"] for s in stats)


# ------------------------------------------------------------------- (d)
def test_cli_under_torchrun_two_ranks(tmp_path):
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--device", "cpu", "--execution",
           "vectorized", "--rounds", "1", "--clients", "4", "--local-epochs", "1",
           "--distill-steps", "2", "--client-store", "spilling", "--client-store-dir",
           str(tmp_path / "spill"), "--ckpt-dir", str(tmp_path / "ckpt")]
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=JOIN_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    history = [ln for ln in proc.stdout.splitlines() if ln.startswith("[fedsdd]")]
    assert len(history) == 1 and re.fullmatch(
        r"\[fedsdd\] round 1/1 acc=\d\.\d{4} kd=\d+\.\d{4}", history[0]), proc.stdout
    assert sum(ln.startswith("done in") for ln in proc.stdout.splitlines()) == 1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_000001.json", "ckpt_000001.npz", "state_000001.json", "state_000001.npz"]
    assert sorted(p.name for p in (tmp_path / "spill").iterdir()) == ["rank0", "rank1"]
