"""Port vs reference: Eq. 2 as a weighted model average.

  (a) ``group_weighted_average`` and ``weighted_average`` (the plain
      versions a CPU tensor takes) against the JAX ``ref`` oracles and
      against the Pallas kernels in interpret mode
      (``REPRO_FORCE_PALLAS=1``, as ``tests/test_engine_parity.py`` runs
      them), at the reference's sweep shape (3, 5, 517), at the vectorized
      ResNet-56 round's largest leaf (G=4, N=2, D=36,864) and for
      ``weighted_average`` at (5, 517); f32 at rtol 1e-5, atol 1e-6 (the
      reference's own), bf16 within one bf16 ulp of the reference's result;
  (b) ``fedavg_aggregate_grouped`` against the listwise ``fedavg_aggregate``
      for ragged groups (the segment reduction) and uniform groups, the
      latter through the kernel route's reshape and one tree call with the
      route forced on (``_kernel_route``; on a CPU tensor the wrapper runs
      its plain version);
  (c) the pytree wrappers over a ResNet-20 parameter tree, leaf by leaf
      against the reference's wrappers on their CPU route (the ref
      oracles; the Pallas route is held in (a) at the shapes above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.resnet_cifar import get_resnet_config as jax_get_resnet_config  # noqa: E402
from repro.core.aggregation import fedavg_aggregate as jax_fedavg_aggregate  # noqa: E402
from repro.kernels.weight_avg import ops as jax_wops  # noqa: E402
from repro.kernels.weight_avg import ref as jax_ref  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.kernels.weight_avg import ops, ref  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_stack  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
GROUP_SHAPES = [(3, 5, 517), (4, 2, 36864)]


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.integers(1, 40, shape[:-1]).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", GROUP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_group_weighted_average_matches_reference(shape, monkeypatch):
    x, w = _case(shape, seed=sum(shape))
    got = ops.group_weighted_average(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want_ref = jax_ref.group_weighted_average_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    want_pallas = jax_wops.group_weighted_average(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
    assert got.shape == shape[:1] + shape[2:]


def test_weighted_average_matches_reference(monkeypatch):
    x, w = _case((5, 517), seed=7)
    got = ops.weighted_average(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.weighted_average_ref(jnp.asarray(x), jnp.asarray(w))), **TOL)
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    np.testing.assert_allclose(
        got, np.asarray(jax_wops.weighted_average(jnp.asarray(x), jnp.asarray(w))), **TOL)


def test_bf16_within_one_ulp():
    """Both sides sum in f32 and round once to bf16; the sums may differ in
    their last f32 bits, which moves a rounding by at most one bf16 ulp."""
    x, w = _case((3, 5, 517), seed=11)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.group_weighted_average(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = jax_ref.group_weighted_average_ref(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2 ** -126))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())


def _models(rng, n):
    return [{"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
             "b": rng.normal(0, 1, (3,)).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("gid", [[0, 0, 0, 0, 1, 1], [0, 0, 0, 1, 1, 1]],
                         ids=["ragged", "uniform"])
def test_grouped_aggregate_matches_listwise(gid, monkeypatch):
    rng = np.random.default_rng(len(set(gid)) + sum(gid))
    ms = _models(rng, 6)
    sizes = rng.integers(1, 50, 6)
    gid = np.asarray(gid)
    uniform = np.bincount(gid).min() == np.bincount(gid).max()
    calls = []
    if uniform:      # drive the kernel route's reshape; the CPU wrapper runs plain
        monkeypatch.setattr(aggregation, "_kernel_route", lambda stacked: True)
        real = ops.group_weighted_average_pytree
        monkeypatch.setattr(ops, "group_weighted_average_pytree",
                            lambda t, w: calls.append(len(tree_leaves(t))) or real(t, w))
    stacked = tree_stack([interop.params_from_numpy(m, device="cpu") for m in ms])
    agg = aggregation.fedavg_aggregate_grouped(stacked, sizes, gid, 2)
    assert calls == ([2] if uniform else [])            # one launch for the tree's 2 leaves
    for g in range(2):
        sel = np.flatnonzero(gid == g)
        want = jax_fedavg_aggregate([jax.tree.map(jnp.asarray, ms[i]) for i in sel], sizes[sel])
        for k in ("w", "b"):
            np.testing.assert_allclose(agg[k][g].numpy(), np.asarray(want[k]), **TOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_pytree_wrappers_over_resnet20(grouped):
    cfg = jax_get_resnet_config("resnet20")
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    jtrees = [jax_resnet.init_resnet(k, cfg) for k in keys]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jtrees)
    stack = interop.params_from_numpy(jax.tree.map(np.asarray, jstack), device="cpu")
    rng = np.random.default_rng(6)
    if grouped:
        w = rng.integers(1, 40, (2, 2)).astype(np.float32)
        got = ops.group_weighted_average_pytree(
            tree_map(lambda x: x.reshape((2, 2) + tuple(x.shape[1:])), stack),
            torch.from_numpy(w))
        want = jax_wops.group_weighted_average_pytree(
            jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]), jstack), jnp.asarray(w))
    else:
        w = rng.integers(1, 40, (4,)).astype(np.float32)
        got = ops.weighted_average_pytree(stack, torch.from_numpy(w))
        want = jax_wops.weighted_average_pytree(jstack, jnp.asarray(w))
    got_np = interop.params_to_numpy(got)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
                 got_np, want)


def test_plain_versions_normalise_in_f32():
    """Unnormalised weights of any type give the normalised mean."""
    x = torch.arange(12.0).reshape(3, 4)
    out = ref.weighted_average_ref(x, torch.tensor([1, 1, 2]))
    torch.testing.assert_close(out, (x[0] + x[1] + 2 * x[2]) / 4)
