"""``repro_torch.sharding.specs`` and ``repro_torch.launch.mesh`` against the
reference's ``repro.sharding.specs`` and ``repro.launch.mesh``.

  (a) ``param_pspec`` equals the reference's leaf by leaf, by key path, for
      every assigned architecture on both production meshes' axis sizes
      ((16, 16) and (2, 16, 16)), tensor-parallel over "model" and FSDP
      over "data"; the reference side is built from
      ``repro.launch.steps.param_specs`` and a shape-only mesh, the port's
      from ``launch.steps.param_specs`` (``meta`` tensors) and
      ``make_production_mesh``.
  (b) ``batch_pspec`` and ``cache_pspec`` equal the reference's for
      train_4k, decode_32k and long_500k (``seq_on_data`` where the batch
      is below the data axis, ``seq_axis`` None, "auto" and "model") over
      the dense GQA, MLA, Mamba + attention and xLSTM families.
  (c) The reference's own invariants (``tests/test_sharding_specs.py``)
      hold on the port: specs mirror the tree and never ask for an
      indivisible split; tensor parallelism engages on half the bytes.
  (d) ``use_shard_map``'s table equals the reference's, with and without
      ``REPRO_FORCE_SHARD_MAP=1``; the meshes' shapes and sizes.
  (e) ``to_shardings`` on a 2 × 2 ("data", "model") mesh of four spawned
      gloo ranks: ``distribute_tensor`` of a reduced qwen2.5-14b's leaves
      (FSDP on, so both axes engage) gives the local shapes the specs
      imply, and ``full_tensor()`` gives the leaf back.
"""
import dataclasses
import json
import math
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

JOIN_S = 120
WORLD = 4
MESHES = {"pod": False, "multi_pod": True}
CACHE_ARCHS = ["qwen2.5-14b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "xlstm-1.3b"]


class FakeMesh:
    """Shape-only stand-in for the reference's mesh."""
    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_flat(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.sharding.specs import _keystr
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {_keystr(path): tuple(spec) for path, spec in pairs}


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, specs.PartitionSpec):
        return {"/".join(str(p) for p in path): tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _port_flat(x, path + (i,)).items()}
    assert tree is None
    return {}


@pytest.fixture(scope="module")
def shapes():
    """{arch: (reference param shapes, port param shapes)}, built on demand."""
    cache: dict = {}

    def get(arch):
        if arch not in cache:
            from repro.configs import get_config as jax_get_config
            from repro.launch import steps as jsteps
            from repro.models import build_model as jax_build_model
            cache[arch] = (jsteps.param_specs(jax_build_model(jax_get_config(arch))),
                           steps.param_specs(build_model(get_config(arch))))
        return cache[arch]
    return get


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("arch", [pytest.param(a, id=a) for a in
                                  ["qwen2.5-14b", "stablelm-3b", "gemma-2b", "starcoder2-3b",
                                   "deepseek-v2-lite-16b", "xlstm-1.3b", "jamba-1.5-large-398b",
                                   "llama4-maverick-400b-a17b", "hubert-xlarge",
                                   "llava-next-mistral-7b"]])
def test_param_pspec_matches_reference(arch, shapes):
    from repro.configs import ASSIGNED_ARCHS
    from repro.configs import get_config as jax_get_config
    from repro.sharding import specs as jspecs
    assert arch in ASSIGNED_ARCHS
    jshapes, pshapes = shapes(arch)
    for multi in MESHES.values():
        mesh = pmesh.make_production_mesh(multi_pod=multi)
        ref = jspecs.param_pspec(jshapes, jax_get_config(arch), FakeMesh(mesh.shape),
                                 fsdp_axis="data")
        got = specs.param_pspec(pshapes, get_config(arch), mesh, fsdp_axis="data")
        assert _port_flat(got) == _ref_flat(ref), (arch, mesh)


def test_assigned_archs_are_covered():
    from repro.configs import ASSIGNED_ARCHS
    ids = {p.id for p in test_param_pspec_matches_reference.pytestmark[0].args[1]}
    assert ids == set(ASSIGNED_ARCHS)


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k", "long_500k"])
def test_batch_and_cache_pspec_match_reference(arch, shape_name):
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import INPUT_SHAPES as JAX_SHAPES
    from repro.launch import steps as jsteps
    from repro.models import build_model as jax_build_model
    from repro.sharding import specs as jspecs
    shape, jshape = INPUT_SHAPES[shape_name], JAX_SHAPES[shape_name]
    cfg = steps.config_for_shape(get_config(arch), shape)
    jcfg = jsteps.config_for_shape(jax_get_config(arch), jshape)
    if not steps.supported(get_config(arch), shape)[0]:
        pytest.skip(f"{arch} does not run {shape_name} (the reference's skip matrix)")
    for multi in MESHES.values():
        mesh = pmesh.make_production_mesh(multi_pod=multi)
        fake = FakeMesh(mesh.shape)
        if shape.kind == "train":
            got = specs.batch_pspec(steps.batch_specs(cfg, shape), shape, mesh)
            ref = jspecs.batch_pspec(jsteps.batch_specs(jcfg, jshape), jshape, fake)
            assert _port_flat(got) == _ref_flat(ref)
            assert _port_flat(got)["tokens"][0] == "data"
            continue
        cache = steps.cache_specs(build_model(cfg), shape)
        jcache = jsteps.cache_specs(jax_build_model(jcfg), jshape)
        seq_on_data = shape.global_batch < mesh.shape["data"]
        for seq_axis in (None, "auto", "model"):
            got = specs.cache_pspec(cache, cfg, mesh, seq_on_data=seq_on_data,
                                    seq_axis=seq_axis)
            ref = jspecs.cache_pspec(jcache, jcfg, fake, seq_on_data=seq_on_data,
                                     seq_axis=seq_axis)
            assert _port_flat(got) == _ref_flat(ref), (arch, shape_name, seq_axis)


# ------------------------------------------------------------------- (c)
def _divides(leaf_shape, spec, mesh) -> bool:
    for dim, ax in zip(leaf_shape, spec):
        if ax is not None:
            size = math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
            if dim % size:
                return False
    return len(spec) <= len(leaf_shape)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "jamba-1.5-large-398b",
                                  "deepseek-v2-lite-16b", "gemma-2b"])
def test_reference_invariants_hold_on_the_port(arch, shapes):
    _, pshapes = shapes(arch)
    mesh = pmesh.make_production_mesh()
    got = specs.param_pspec(pshapes, get_config(arch), mesh, fsdp_axis="data")
    flat_shapes = {k: tuple(x.shape) for k, x in _port_flat_leaves(pshapes).items()}
    flat_specs = _port_flat(got)
    assert flat_shapes.keys() == flat_specs.keys()
    assert all(_divides(flat_shapes[k], flat_specs[k], mesh) for k in flat_specs)
    tot = sum(math.prod(s) for s in flat_shapes.values())
    sharded = sum(math.prod(flat_shapes[k]) for k, sp in flat_specs.items()
                  if "model" in [a for ax in sp if ax for a in
                                 (ax if isinstance(ax, tuple) else (ax,))])
    assert sharded / tot > 0.5, (arch, sharded / tot)


def _port_flat_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_flat_leaves(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _port_flat_leaves(x, path + (i,)).items()}
    return {"/".join(str(p) for p in path): tree}


def test_client_stack_pspec_matches_reference():
    import jax.numpy as jnp

    from repro.sharding import specs as jspecs
    tree = {"a": {"w": np.zeros((4, 3, 2), np.float32)}, "b": [np.zeros((4,), np.float32)]}
    got = specs.client_stack_pspec({"a": {"w": torch.zeros(4, 3, 2)}, "b": [torch.zeros(4)]})
    ref = jspecs.client_stack_pspec({"a": {"w": jnp.asarray(tree["a"]["w"])},
                                     "b": [jnp.asarray(tree["b"][0])]})
    assert _port_flat(got) == _ref_flat(ref) == {"a/w": ("clients", None, None), "b/0": ("clients",)}


# ------------------------------------------------------------------- (d)
@pytest.mark.parametrize("forced", [False, True])
def test_use_shard_map_table_matches_reference(forced, monkeypatch):
    from repro.launch import mesh as jmesh
    if forced:
        monkeypatch.setenv("REPRO_FORCE_SHARD_MAP", "1")
    else:
        monkeypatch.delenv("REPRO_FORCE_SHARD_MAP", raising=False)
    for n in (None, 1, 4):
        port_mesh = None if n is None else pmesh.Mesh({"clients": n})
        ref_mesh = None if n is None else FakeMesh({"clients": n})
        for policy in ("auto", "vmap", "shard_map"):
            got = pmesh.use_shard_map(port_mesh, policy)
            assert got == jmesh.use_shard_map(ref_mesh, policy), (n, policy, forced)
            if n is not None:
                assert pmesh.mesh_size(port_mesh) == jmesh.mesh_size(ref_mesh) == n


def test_meshes_without_a_process_group():
    assert pmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert pmesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                                "model": 16}
    assert pmesh.mesh_size(pmesh.make_production_mesh(multi_pod=True)) == \
        pmesh.PODS * pmesh.CHIPS_PER_POD
    client = pmesh.make_client_mesh()
    assert client.shape == {"clients": 1} and client.group is None and client.rank == 0
    assert pmesh.make_local_mesh(4, 2).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="every rank"):
        pmesh.make_client_mesh(4)
    with pytest.raises(ValueError, match="DeviceMesh"):
        pmesh.make_production_mesh().device_mesh()
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.all_reduce_sum(x, client) is x
    tree = {"w": x, "n": 3}
    assert pmesh.all_gather_tree(tree, client) is tree


# ------------------------------------------------------------------- (e)
def _spec_local_shape(shape, spec, mesh_shape: dict) -> tuple:
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[d] //= mesh_shape[a]
    return tuple(out)


def _dtensor_rank(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = pmesh.make_local_mesh(2, 2)
        assert mesh.shape == {"data": 2, "model": 2} and mesh.group is not None
        cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(), fsdp=True)
        params = build_model(cfg).init(0, device="cpu")
        spec = specs.param_pspec(params, cfg, mesh, fsdp_axis="data")
        shardings = specs.to_shardings(spec, mesh)
        rows = {}
        for key, leaf in _port_flat_leaves(params).items():
            sh = _port_flat_leaves(shardings)[key]
            d = sh.distribute(leaf)
            rows[key] = {"spec": list(sh.spec), "placements": [repr(p) for p in sh.placements],
                         "local": list(d.to_local().shape),
                         "want": list(_spec_local_shape(leaf.shape, sh.spec, mesh.shape)),
                         "round_trip": bool(torch.equal(d.full_tensor(), leaf))}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def test_to_shardings_on_a_four_rank_gloo_mesh(tmp_path):
    deadline = time.monotonic() + JOIN_S
    ctx = torch.multiprocessing.start_processes(
        _dtensor_rank, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=WORLD,
        join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"the spawned ranks did not finish within {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]
    for rows in ranks:
        assert all(r["local"] == r["want"] and r["round_trip"] for r in rows.values()), rows
    axes = {a for r in ranks[0].values() for a in r["spec"] if a}
    assert axes == {"data", "model"}
    both = [k for k, r in ranks[0].items() if "data" in r["spec"] and "model" in r["spec"]]
    assert both, "no leaf is split over both mesh axes"
