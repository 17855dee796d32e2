"""The port's fedckpt (``repro_torch/fedckpt/checkpointer.py``) against the
reference's, the spec of ``tests/test_checkpointer.py``.

  (a) round trips are exact (bf16 leaves through their f32 containers, int
      leaves, lists and NamedTuples); a shape mismatch raises; retention,
      ``latest`` and ``restore_latest``;
  (b) durability: the published name is exactly the path and no ``.tmp``
      survives; a ``Checkpointer`` cleans stale ``.tmp`` files; the meta
      always carries a crc32; a corrupt step fails ``verify`` and
      ``restore_latest`` falls back past it; the I/O retry loop recovers
      from transient failures and gives up after its budget;
  (c) cross-package: a tree saved by ``repro.fedckpt`` loads in the port,
      and the reverse, exactly, with the same names in the archive (bf16
      leaves and NamedTuple fields included); a client-state spill of
      either is found by the other's ``spilled_client_ids``;
  (d) a vectorized round's aggregate (its leaves views of one allocation)
      goes to disk within 1% plus 4 KB of its leaves' own bytes.
"""
import glob
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fedckpt import checkpointer as jax_ckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.fedckpt import checkpointer as ckpt  # noqa: E402
from repro_torch.fedckpt.checkpointer import Checkpointer, load_pytree, save_pytree  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402


class Pair(NamedTuple):
    base: object
    c_local: object


def tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "layer": {"w": torch.randn((4, 3), generator=g),
                  "b": (torch.randn((3,), generator=g) * 3).to(torch.bfloat16)},
        "stack": [torch.arange(5), torch.ones((2, 2), dtype=torch.int32)],
        "opt": Pair(torch.randn((2,), generator=g), {"v": torch.full((1,), 2.0 + 2 ** -9)}),
    }


def zeros_like(t):
    return tree_map(torch.zeros_like, t)


def assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ------------------------------------------------------------------- (a)
def test_roundtrip(tmp_path):
    t = tree(0)
    p = str(tmp_path / "x.npz")
    save_pytree(p, t)
    t2 = load_pytree(p, zeros_like(t))
    assert_equal(t, t2)
    assert t2["layer"]["b"].dtype == torch.bfloat16
    assert isinstance(t2["opt"], Pair) and isinstance(t2["stack"], list)
    with np.load(p) as data:          # bf16 as an f32 container, the reference's names
        assert data["layer§b"].dtype == np.float32
        assert sorted(data.files) == sorted(["layer§w", "layer§b", "stack§0", "stack§1",
                                             "opt§.base", "opt§.c_local§v"])


def test_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "x.npz")
    save_pytree(p, {"w": torch.zeros((2,))})
    with pytest.raises(ValueError):
        load_pytree(p, {"w": torch.zeros((3,))})


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s), meta={"round": s})
    assert ck.steps() == [3, 4] and ck.latest() == 4
    assert_equal(tree(4), ck.restore(4, zeros_like(tree(4))))
    step, _ = ck.restore_latest(zeros_like(tree(4)))
    assert step == 4 and ck.load_meta(4)["round"] == 4


# ------------------------------------------------------------------- (b)
def test_save_pytree_publishes_exact_path_no_tmp(tmp_path):
    p = str(tmp_path / "exact.npz")
    save_pytree(p, {"w": torch.arange(3.0)})
    assert list(tmp_path.iterdir()) == [tmp_path / "exact.npz"]


def test_checkpointer_cleans_stale_tmp_on_startup(tmp_path):
    (tmp_path / "ckpt_000007.npz.tmp").write_bytes(b"crashed mid-write")
    ck = Checkpointer(str(tmp_path))
    assert not list(tmp_path.glob("*.tmp")) and ck.steps() == []


def test_spilled_client_ids_ignores_and_cleans_tmp(tmp_path):
    save_pytree(ckpt.client_state_path(str(tmp_path), "ctrl", 3), {"w": torch.zeros(2)})
    (tmp_path / "ctrl_c00000009.npz.tmp").write_bytes(b"junk")
    assert ckpt.spilled_client_ids(str(tmp_path), "ctrl") == [3]
    assert not list(tmp_path.glob("*.tmp"))


def test_meta_always_carries_checksum(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree(1))
    meta = ck.load_meta(1)
    assert meta is not None and "crc32" in meta and ck.verify(1)


def test_restore_latest_falls_back_past_corrupt_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=4)
    for s in (1, 2, 3):
        ck.save(s, tree(s), meta={"round": s})
    with open(tmp_path / "ckpt_000003.npz", "r+b") as f:
        f.write(b"\x00" * 48)                # checksum mismatch
    (tmp_path / "ckpt_000002.npz").write_bytes(b"")   # truncated to nothing
    assert not ck.verify(3)
    step, got = ck.restore_latest(zeros_like(tree(1)))
    assert step == 1
    assert_equal(tree(1), got)


def test_restore_latest_none_when_all_corrupt(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree(1))
    with open(tmp_path / "ckpt_000001.npz", "r+b") as f:
        f.write(b"\x00" * 48)
    assert ck.restore_latest(zeros_like(tree(1))) is None


def test_io_retry_recovers_and_exhaustion_raises(tmp_path):
    calls = []

    def flaky(path, attempt):
        calls.append(attempt)
        if attempt < 2:
            raise OSError("transient")

    p = str(tmp_path / "x.npz")
    ckpt.set_io_fault_injector(flaky)
    try:
        save_pytree(p, {"w": torch.arange(4.0)})
        got = load_pytree(p, {"w": torch.zeros(4)})
    finally:
        ckpt.set_io_fault_injector(None)
    assert torch.equal(got["w"], torch.arange(4.0)) and max(calls) == 2
    assert not glob.glob(str(tmp_path / "*.tmp"))
    ckpt.set_io_fault_injector(lambda path, attempt: (_ for _ in ()).throw(OSError("gone")))
    try:
        with pytest.raises(OSError):
            save_pytree(str(tmp_path / "y.npz"), {"w": torch.zeros(2)})
    finally:
        ckpt.set_io_fault_injector(None)


# ------------------------------------------------------------------- (c)
def _np(t):
    return jax.tree.map(np.asarray, t)


class JPair(NamedTuple):
    base: object
    c_local: object


def jtree(seed):
    k = jax.random.PRNGKey(seed)
    return {"layer": {"w": jax.random.normal(k, (4, 3)),
                      "b": (jax.random.normal(k, (3,)) * 3).astype(jnp.bfloat16)},
            "stack": [jnp.arange(5), jnp.ones((2, 2), jnp.int32)],
            "opt": JPair(jnp.full((2,), 1.5), {"v": jnp.full((1,), 2.0 + 2 ** -9)})}


def _port_of(jt):
    n = _np(jt)
    return {"layer": interop.params_from_numpy(n["layer"], device="cpu"),
            "stack": [torch.from_numpy(np.array(x)) for x in n["stack"]],
            "opt": Pair(torch.from_numpy(np.array(n["opt"].base)),
                        {"v": torch.from_numpy(np.array(n["opt"].c_local["v"]))})}


def test_jax_checkpoint_loads_in_port(tmp_path):
    jt = jtree(1)
    jax_ckpt.Checkpointer(str(tmp_path), prefix="state").save(7, jt, meta={"round": 7})
    ck = Checkpointer(str(tmp_path), prefix="state")
    assert ck.steps() == [7] and ck.verify(7)
    want = _port_of(jt)
    assert_equal(want, ck.restore(7, zeros_like(want)))


def test_port_checkpoint_loads_in_jax(tmp_path):
    jt = jtree(2)
    t = _port_of(jt)
    Checkpointer(str(tmp_path)).save(3, t, meta={"round": 3})
    jck = jax_ckpt.Checkpointer(str(tmp_path))
    assert jck.verify(3)
    got = jck.restore(3, jax.tree.map(jnp.zeros_like, jt))
    assert got["layer"]["b"].dtype == jnp.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32),
                                                            np.asarray(b, np.float32)), jt, got)


def test_client_spills_cross_package(tmp_path):
    d = str(tmp_path)
    jax_ckpt.save_pytree(jax_ckpt.client_state_path(d, "ctrl", 5), {"w": jnp.full((2,), 3.0)})
    save_pytree(ckpt.client_state_path(d, "ctrl", 2), {"w": torch.full((2,), 4.0)})
    assert ckpt.spilled_client_ids(d, "ctrl") == jax_ckpt.spilled_client_ids(d, "ctrl") == [2, 5]
    got = load_pytree(ckpt.client_state_path(d, "ctrl", 5), {"w": torch.zeros(2)})
    assert torch.equal(got["w"], torch.full((2,), 3.0))
    back = jax_ckpt.load_pytree(jax_ckpt.client_state_path(d, "ctrl", 2), {"w": jnp.zeros(2)})
    np.testing.assert_array_equal(np.asarray(back["w"]), np.full(2, 4.0))


def test_spill_members_layout_matches_reference(tmp_path):
    stacked = {"w": torch.arange(12.0).reshape(3, 4), "b": [torch.ones((3, 2))]}
    paths = ckpt.spill_members(str(tmp_path / "p"), 9, stacked)
    jpaths = jax_ckpt.spill_members(str(tmp_path / "j"), 9,
                                    jax.tree.map(lambda x: jnp.asarray(x.numpy()), stacked))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, jp in zip(paths, jpaths):
        with np.load(p) as a, np.load(jp) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------- (d)
def test_views_of_one_allocation_write_their_own_bytes(tmp_path):
    """The vectorized engine's aggregate: every leaf a view of one storage
    (``kernels/weight_avg/ops.py``); the npz holds each view's elements."""
    from repro_torch.kernels.weight_avg.ops import group_weighted_average_pytree
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 16, 16), (16,), (16,), (3, 3, 16, 32), (32,), (32, 10), (10,)]
    regrouped = {f"l{i}": torch.from_numpy(rng.normal(0, 1, (4, 2) + s).astype(np.float32))
                 for i, s in enumerate(shapes)}
    agg = group_weighted_average_pytree(regrouped, torch.ones((4, 2)))
    assert len({x.untyped_storage().data_ptr() for x in tree_leaves(agg)}) == 1
    model = tree_map(lambda x: x[1], agg)
    p = str(tmp_path / "m.npz")
    save_pytree(p, model)
    leaf_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(model))
    storage = tree_leaves(agg)[0].untyped_storage().nbytes()
    size = os.path.getsize(p)
    assert leaf_bytes <= size <= 1.01 * leaf_bytes + 4096 < storage, (size, leaf_bytes, storage)
