"""``repro_torch.launch.dryrun`` and ``launch.perf``: the dry run over a
fake process group, held against the reference's own pieces.

``repro.launch.dryrun`` and ``repro.launch.perf`` are not imported here:
they set ``XLA_FLAGS`` when imported (``tests/conftest.py``).  The
reference side is ``repro.launch.steps``, ``repro.models.build_model(cfg,
unroll=True)`` and ``jax.jit(...).lower(...).compile().cost_analysis()``.

  (a) On a one-rank world, a ``reduced()`` dense model's train and prefill
      steps: the port's FLOPs (products only) are at most XLA's count of
      the unrolled program on one device (which also counts elementwise
      ops) and at least ``XLA_FLOOR`` of it (measured 0.981-0.993 for
      qwen2.5-14b, gemma-2b and stablelm-3b at 2 x 32 and 2 x 64 tokens);
      ``model_flops_global`` is the reference's formula exactly.
  (b) The count is linear in depth: cost(full) == cost(d1) + (n_super -
      1)·(cost(d2) - cost(d1)) exactly, for FLOPs, bytes and collective
      bytes, on a fake 2 x 2 world.
  (c) Partitioning: a tensor-parallel toy product on a fake 2 x 2 world
      counts the global FLOPs / 4 and the all-gathers its layout implies;
      every assigned architecture's ``reduced()`` train, prefill and
      decode steps run on a fake 2 x 2 world; the FedSDD round records the
      teacher all-reduce at the server rows' logits on one rank (rows x S
      x V / "model" x 4 bytes, PERF.md §3), the same for 2 and 4 clients a
      group.
  (d) ``remat=True`` raises the FLOPs and lowers the peak against False;
      ``"dots"`` lies between them in FLOPs.
  (e) A record renders through ``benchmarks/roofline.py``'s ``fmt_row``;
      ``perf.EXPERIMENTS`` has the reference's seven names; ``main`` exits
      non-zero when a combination fails; a live default group is refused.
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import InputShape as JaxShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ONE = {"data": 1, "model": 1}
TWO_BY_TWO = {"data": 2, "model": 2}
XLA_FLOOR = 0.97
SHAPES = {"train": InputShape("train_4k", 32, 4, "train"),
          "prefill": InputShape("prefill_32k", 32, 4, "prefill"),
          "decode": InputShape("decode_32k", 64, 4, "decode")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(layers=None):
    def cut(cfg):
        cfg = cfg.reduced()
        return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
    return cut


def _count(arch, kind, **kw):
    shape = SHAPES[kind]
    kw.setdefault("cfg_override", _reduced())
    kw.setdefault("mesh_shape", TWO_BY_TWO)
    return dryrun.lower_one(arch, shape.name, shape_override=shape, **kw)


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_against_xla(kind):
    arch = "qwen2.5-14b"
    jcfg = jax_get_config(arch).reduced()
    model = jax_build_model(jcfg, unroll=True)
    shape = SHAPES[kind]
    p_specs = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    b_specs = jsteps.batch_specs(jcfg, JaxShape("x", shape.seq_len, shape.global_batch, kind))
    fn = jsteps.make_train_step(model) if kind == "train" else jsteps.make_prefill_step(model)
    cost = jax.jit(fn).lower(p_specs, b_specs).compile().cost_analysis()
    xla = (cost[0] if isinstance(cost, list) else cost)["flops"]
    rec = _count(arch, kind, mesh_shape=ONE)
    assert rec["counted"] == "plain ops" and rec["chips"] == 1
    port = rec["flops_per_chip"]
    assert XLA_FLOOR * xla <= port <= xla, (port, xla, port / xla)
    tokens = shape.global_batch * shape.seq_len
    assert rec["model_flops_global"] == (6 if kind == "train" else 2) \
        * jcfg.num_active_params() * tokens


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("arch,layers", [("qwen2.5-14b", 3), ("deepseek-v2-lite-16b", 4)])
def test_count_is_linear_in_depth(arch, layers):
    rec = _count(arch, "train", cfg_override=_reduced(layers))
    n = rec["n_super"]
    assert n == 3
    d1, d2 = rec["shallow_raw"]["d1"], rec["shallow_raw"]["d2"]
    for key, raw in (("flops_per_chip", "flops"), ("hbm_bytes_per_chip", "bytes"),
                     ("collective_bytes_per_chip", "coll_bytes")):
        assert rec[key] == d1[raw] + (n - 1) * (d2[raw] - d1[raw]), key
    assert d2["flops"] > d1["flops"] > 0 and d2["coll_bytes"] > d1["coll_bytes"] > 0


def test_shallow_cfgs_are_one_and_two_superblocks():
    cfg = get_config("deepseek-v2-lite-16b")
    c1, c2, n = dryrun._shallow_cfgs(cfg)
    q, p = build_model(cfg).prefix_period
    assert n == build_model(cfg).n_super
    for c, k in ((c1, 1), (c2, 2)):
        m = build_model(c)
        assert m.prefix_period == (q, p) and m.n_super == k


# ------------------------------------------------------------------- (c)
def test_tensor_parallel_toy_counts_one_rank():
    """x (8, 64) split over "data" @ w (64, 32) split over "model": each
    rank multiplies its 4 rows by its 16 columns; making the product whole
    all-gathers it over "model" (4 x 32 f32) then "data" (8 x 32)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis import collective_stats
    with dryrun.fake_world((2, 2), ("data", "model")) as (_, dm), \
            FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.zeros(8, 64), dm, [Shard(0), Replicate()])
        w = distribute_tensor(torch.zeros(64, 32), dm, [Replicate(), Shard(1)])
        count = dryrun.RankCount()
        with collective_stats() as coll, count.counting(), implicit_replication():
            y = (x @ w).redistribute(placements=[Replicate(), Replicate()])
        assert tuple(y.to_local().shape) == (8, 32)
    assert count.flops == 2 * 8 * 64 * 32 // 4
    assert coll.bytes_by_kind == {"all-gather": (4 * 32 + 8 * 32) * 4}
    assert coll.count_by_kind == {"all-gather": 2}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_architecture_runs_partitioned(arch):
    """Train, prefill and decode of the reduced model on a fake 2 x 2 world
    (decode only where the skip matrix has it): each counts products,
    bytes and collectives of its shards."""
    for kind in SHAPES:
        rec = _count(arch, kind, proof_only=True)
        if not rec["supported"]:
            assert kind == "decode" and get_config(arch).is_encoder
            continue
        assert rec["scan_raw_flops_per_chip"] > 0, kind
        assert rec["collective_bytes_scan_body"] > 0, kind
        mem = rec["memory_analysis"]
        assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0, kind


def test_fedsdd_teacher_all_reduce_does_not_grow_with_clients():
    """The round on a fake (2, 2, 2) world over ("pod", "data", "model"):
    the teacher logits' sum over "pod" is the server rows on one rank (2 /
    "data" = 1) x S x V / "model" f32, for 2 and 4 clients a group."""
    arch = "gemma-2b"
    cfg = get_config(arch).reduced()
    shape = SHAPES["train"]
    out = {}
    for clients in (2, 4):
        rec = dryrun.lower_one(
            arch, shape.name, multi_pod=True, fedsdd=True, cfg_override=_reduced(),
            shape_override=shape, mesh_shape={"pod": 2, "data": 2, "model": 2},
            spec_overrides=dict(clients_per_group=clients, client_batch=1, server_batch=2),
            proof_only=True)
        assert rec["step_kind"] == "fedsdd_round"
        out[clients] = rec["teacher_all_reduce_bytes"]
    assert out[2] == out[4] == 1 * shape.seq_len * (cfg.vocab_size // 2) * 4


# ------------------------------------------------------------------- (d)
def test_remat_in_the_count():
    """At 4 x 256 tokens, where the layers' activations outweigh the
    weights and their gradients."""
    shape = InputShape("train_4k", 256, 4, "train")
    recs = {r: dryrun.lower_one("qwen2.5-14b", shape.name, shape_override=shape,
                                mesh_shape=ONE, cfg_override=_reduced(4), remat=r,
                                proof_only=True) for r in (False, True, "dots")}
    flops = {r: rec["scan_raw_flops_per_chip"] for r, rec in recs.items()}
    peak = {r: rec["memory_analysis"]["peak_size_in_bytes"] for r, rec in recs.items()}
    assert flops[False] < flops["dots"] < flops[True]
    assert peak[True] < peak[False]


# ------------------------------------------------------------------- (e)
def _roofline_module():
    spec = importlib.util.spec_from_file_location("roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_records_render_through_roofline(tmp_path):
    roofline = _roofline_module()
    rec = _count("gemma-2b", "train", mesh_shape=ONE)
    path = dryrun.save_rec(rec, str(tmp_path))
    (loaded,) = roofline.load(str(tmp_path))
    row = roofline.fmt_row(loaded, md=True).split(" | ")
    assert row[:4] == ["gemma-2b", "train_4k", "pod1", "train"]
    assert row[7] == rec["dominant"] and float(row[8]) == pytest.approx(
        rec["useful_flops_ratio"], abs=0.005)
    assert Path(path).name == "gemma-2b__train_4k__pod1.json"
    skip = dryrun.lower_one("hubert-xlarge", "decode_32k")
    assert not skip["supported"] and "SKIP" in roofline.fmt_row(skip)


def test_perf_has_the_reference_experiments():
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "perf.py").read_text())
    names = [d.args[0].value for n in tree.body if isinstance(n, ast.FunctionDef)
             for d in n.decorator_list if isinstance(d, ast.Call)]
    assert sorted(perf.EXPERIMENTS) == sorted(names) and len(names) == 7


def test_main_exits_nonzero_on_a_failure(tmp_path, monkeypatch):
    def fails(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "lower_one", fails)
    monkeypatch.setattr(perf, "lower_one", fails)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        perf.main(["--exp", "train_noremat", "--out", str(tmp_path)])
    assert e.value.code not in (0, None)


def test_fake_world_refuses_a_live_group_and_leaves_none(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="live already"):
            with dryrun.fake_world((2, 2), ("data", "model")):
                pass
    finally:
        dist.destroy_process_group()
    with dryrun.fake_world((2, 2), ("data", "model")):
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    # a dry run leaves the plain model as it was
    model = build_model(get_config("qwen2.5-14b").reduced())
    params = model.init(0, device="cpu")
    logits, _ = model.logits(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    assert type(logits) is torch.Tensor and bool(torch.isfinite(logits).all())
