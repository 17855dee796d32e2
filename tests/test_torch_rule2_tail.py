"""Kernels 5 and 2's redesigns (``csrc/weight_avg.cu``, ``csrc/kd_loss.cu``):
their launch plans and their arithmetic, on the CPU.

(a) ``wa_tree_plan``: every element of every leaf is covered by exactly one
    tile of one launch (the kernel's binary search over the table's tile
    prefix, emulated), for trees of 1 to 2,000 leaves with 1-element and
    odd-D leaves; output slices are 16-byte aligned and do not overlap;
    f32 and bf16 leaves go in separate launches; each launch's table fits
    the 32,764-byte parameter block; ResNet-56's tree is one launch.
(b) The tree form on the CPU, whose leaves are views of one allocation laid
    out by the plan, against the JAX ``group_weighted_average_pytree``: on
    ResNet-56's tree at G 4, N 2 through the JAX ref, and on a small mixed
    tree (1-element and odd-D leaves) through the Pallas kernel in
    interpret mode (``REPRO_FORCE_PALLAS=1``), at rtol 1e-5 / atol 1e-6,
    the reference's own.
(c) ``ensemble_plan``: each row is covered once (a block of whole rows, or
    slices of one row) within a CTA's 227 KB, for V 1 to 256,000, M 1 to 8,
    N 1 / 256 / 2,048, f32 and bf16.
(d) A plain-torch emulation of kernel 2's arithmetic, the staged path (each
    slice's mean in m order, the slice's max, then its sum, the states
    merged in rank order) and the small path (each row's max and sum),
    against the plain version and the JAX Pallas ``ensemble_softmax`` in
    interpret mode at V 10, 517, 4,096 and 50,304, also under plans with
    clusters of up to 8 CTAs: per row at 1e-5 of its max, from f32 and
    from bf16 teacher logits (phase 6's tolerance).  Within
    a slice the emulation sums in torch's order, not the kernel's threads':
    what it checks is the decomposition.
(e) A vectorized CPU round (``test_torch_engine.py``'s uniform ``fedsdd``
    case, Eq. 2 through the kernel route with its plain version) matches the
    JAX vectorized runner, and the aggregate's leaves share one storage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.resnet_cifar import get_resnet_config as jax_get_resnet_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.kernels.kd_loss import ops as jax_kd_ops  # noqa: E402
from repro.kernels.weight_avg import ops as jax_wops  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.core.fedsdd import make_runner  # noqa: E402
from repro_torch.kernels.kd_loss import ops as kd_ops  # noqa: E402
from repro_torch.kernels.kd_loss import ref as kd_ref  # noqa: E402
from repro_torch.kernels.weight_avg import ops  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CARD_SMEM = 232448                        # 227 KB: the most one CTA may hold
STATIC_SMEM = 1024                        # the kernels' static shared memory, at most
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture()
def force_pallas(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")


# ------------------------------------------------------------------ (a)
def _tree_spec(n_leaves: int, seed: int):
    """(dtype, D) leaves: 1-element, odd and even D, f32 and bf16 mixed."""
    rng = np.random.default_rng(seed)
    kinds = [1, 2, 3, 10, 517, 1024, 2049, 36864]
    return [(F32 if rng.random() < 0.6 else BF16, int(rng.choice(kinds)) + int(rng.integers(0, 2)))
            for _ in range(n_leaves)]


PARAM_LIMIT = 32764                       # a launch's parameters: CUDA >= 12.1, sm_70 on


def _param_bytes(cap: int) -> int:
    """csrc/weight_avg.cu's launch parameters with a table of ``cap`` leaves:
    x (8 bytes), the output's 16-byte offset, D and the first tile (4 each)
    a leaf, one more tile and the count, then the output, weights and N."""
    return -(-(20 * cap + 8) // 8) * 8 + 24


@pytest.mark.parametrize("G,N", [(4, 2), (1, 5), (3, 7)])
@pytest.mark.parametrize("n_leaves", [1, 2, 169, 1024, 1025, 2000])
def test_wa_tree_plan_covers_each_element_once(n_leaves, G, N):
    leaves = _tree_spec(n_leaves, seed=n_leaves + G)
    plan = ops.wa_tree_plan(leaves, G, N)
    assert _param_bytes(ops.WA_MAX_LEAVES) <= PARAM_LIMIT
    covered = [np.zeros(D, np.int64) for _, D in leaves]
    seen_dtypes = []
    for p in plan["launches"]:
        assert 1 <= len(p["leaves"]) <= ops.WA_MAX_LEAVES
        assert all(leaves[i][0] == p["dtype"] for i in p["leaves"])
        assert list(p["leaves"]) == sorted(p["leaves"])
        cols = ops.WA_THREADS * (16 // p["dtype"].itemsize)
        tile0 = p["tile0"]
        assert tile0[0] == 0 and tile0[-1] == p["grid"] and tile0.dtype == np.int32
        for tile in range(p["grid"]):          # the kernel's binary search
            lo, hi = 0, len(p["leaves"]) - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if tile0[mid] <= tile else (lo, mid - 1)
            i, D = p["leaves"][lo], int(p["D"][lo])
            assert int(p["out16"][lo]) * 16 == plan["offsets"][i]
            c0 = (tile - tile0[lo]) * cols
            assert 0 <= c0 < D
            covered[i][c0:min(D, c0 + cols)] += 1
        seen_dtypes.append(p["dtype"])
    assert all((c == 1).all() for c in covered)
    assert seen_dtypes == sorted(seen_dtypes, key=lambda d: d != F32)   # f32 first, then bf16
    ends = 0
    for (dtype, D), off in zip(leaves, plan["offsets"]):
        assert off % 16 == 0 and off >= ends
        ends = off + G * D * dtype.itemsize
    assert ends <= plan["nbytes"] and plan["nbytes"] % 16 == 0
    per_dtype = {dt: sum(1 for d, _ in leaves if d == dt) for dt in (F32, BF16)}
    assert len(plan["launches"]) == sum(-(-n // ops.WA_MAX_LEAVES) for n in per_dtype.values())


def _resnet56_stack(seed: int, G: int = 4, N: int = 2):
    """ResNet-56's parameter tree stacked (G, N, ...) from G * N inits."""
    cfg = jax_get_resnet_config("resnet56")
    keys = jax.random.split(jax.random.PRNGKey(seed), G * N)
    trees = [jax_resnet.init_resnet(k, cfg) for k in keys]
    return jax.tree.map(lambda *xs: jnp.stack(xs).reshape((G, N) + xs[0].shape), *trees)


def test_wa_tree_plan_resnet56_is_one_launch():
    jstack = _resnet56_stack(0)
    leaves = [(F32, int(np.prod(x.shape[2:]))) for x in jax.tree.leaves(jstack)]
    assert len(leaves) == 169 and sum(D for _, D in leaves) == 855_578
    plan = ops.wa_tree_plan(leaves, 4, 2)
    assert len(plan["launches"]) == 1 and len(plan["launches"][0]["leaves"]) == 169
    with pytest.raises(ValueError, match="float16"):
        ops.wa_tree_plan([(torch.float16, 4)], 4, 2)


# ------------------------------------------------------------------ (b)
def _one_storage(leaves):
    assert len({x.untyped_storage().data_ptr() for x in leaves}) == 1
    assert all(x.data_ptr() % 16 == 0 and x.is_contiguous() for x in leaves)


def test_tree_form_matches_reference_on_resnet56():
    jstack = _resnet56_stack(1)
    stack = interop.params_from_numpy(jax.tree.map(np.asarray, jstack), device="cpu")
    w = np.random.default_rng(2).integers(1, 7000, (4, 2)).astype(np.float32)
    got = ops.group_weighted_average_pytree(stack, torch.from_numpy(w))
    _one_storage(tree_leaves(got))
    want = jax_wops.group_weighted_average_pytree(jstack, jnp.asarray(w))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
                 interop.params_to_numpy(got), want)


MIXED = {"conv": (3, 3, 4, 8), "one": (1,), "odd": (517,), "bias": (10,), "col": (7, 3)}


@pytest.mark.parametrize("grouped", [True, False], ids=["group", "single"])
def test_tree_form_matches_pallas_on_a_mixed_tree(grouped, force_pallas):
    rng = np.random.default_rng(3)
    lead = (3, 4) if grouped else (5,)
    tree = {k: rng.normal(0, 1, lead + shp).astype(np.float32) for k, shp in MIXED.items()}
    w = rng.integers(1, 40, lead).astype(np.float32)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    if grouped:
        got = ops.group_weighted_average_pytree(tt, torch.from_numpy(w))
        want = jax_wops.group_weighted_average_pytree(
            {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(w))
    else:
        got = ops.weighted_average_pytree(tt, torch.from_numpy(w))
        want = jax_wops.weighted_average_pytree({k: jnp.asarray(v) for k, v in tree.items()},
                                                jnp.asarray(w))
    _one_storage(list(got.values()))
    for k in MIXED:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_tree_form_lays_out_mixed_dtypes_as_planned():
    """A bf16 leaf between f32 ones: one allocation, the plan's offsets, each
    leaf its plain version's result."""
    g = torch.Generator().manual_seed(4)
    tree = [torch.randn((4, 2, 5), generator=g), torch.randn((4, 2, 3), generator=g).to(BF16),
            torch.randn((4, 2, 1), generator=g)]
    w = torch.tensor([[1.0, 2.0]] * 4)
    out = ops.group_weighted_average_pytree(tree, w)
    _one_storage(out)
    plan = ops.wa_tree_plan([(x.dtype, x[0, 0].numel()) for x in tree], 4, 2)
    base = out[0].data_ptr()
    assert [o.data_ptr() - base for o in out] == plan["offsets"]
    assert [o.dtype for o in out] == [F32, BF16, F32]
    for x, o in zip(tree, out):
        assert torch.equal(o, ops.group_weighted_average(x, w))


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("N", [1, 256, 2048])
@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("elt", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("V", [1, 10, 517, 1024, 1025, 4096, 50304, 152064, 256000])
def test_ensemble_plan_covers_each_row_once(V, elt, M, N):
    p = kd_ops.ensemble_plan(M, N, V, elt)
    assert 0 <= p["smem"] and p["smem"] + STATIC_SMEM <= CARD_SMEM
    if p["path"] == "small":
        assert V <= kd_ops.KD_ROW_MAX_V and p["cluster"] == 1 and p["slices"] == [(0, V)]
        rows, lanes = p["rows"], p["lanes"]
        assert p["grid"] * rows >= N > (p["grid"] - 1) * rows       # every row in one block
        assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0 and lanes <= max(1, 2 * V)
        assert rows * lanes <= kd_ops.ENS_SMALL_THREADS
        assert p["smem"] >= 4 * (rows * V + 3)
    else:
        assert V > kd_ops.KD_ROW_MAX_V and p["grid"] == N * p["cluster"]
        covered = np.zeros(V, np.int64)
        for q, (lo, hi) in enumerate(p["slices"]):
            assert lo == min(V, q * p["slice"]) and lo <= hi <= min(V, lo + p["slice"])
            covered[lo:hi] += 1
        assert (covered == 1).all()
        assert 1 <= p["cluster"] <= kd_ops.KD_MAX_CLUSTER
        assert p["smem"] >= 4 * (p["slice"] + 3)
        assert p["smem"] <= kd_ops.KD_CTA_SHARE or p["cluster"] == kd_ops.KD_MAX_CLUSTER


def test_ensemble_plan_sizes_of_the_main_paths():
    """The FedSDD round's 8 x 2,048 x 10 is blocks of whole rows; an LM row is
    the fewest CTAs, up to 16, whose f32 z keeps to 110 KB a CTA."""
    p = kd_ops.ensemble_plan(8, 2048, 10, 4)
    assert (p["path"], p["rows"], p["lanes"], p["grid"]) == ("small", 50, 2, 41)
    assert kd_ops.ensemble_plan(8, 2048, 10, 2)["rows"] == 100      # 2,000 bytes: whole groups
    for (M, N, V, elt), cluster in {(4, 256, 152064, 4): 6, (4, 256, 152064, 2): 6,
                                    (8, 512, 256000, 4): 10, (8, 512, 256000, 2): 10,
                                    (3, 4, 4096, 4): 1, (3, 4, 50304, 2): 2}.items():
        p = kd_ops.ensemble_plan(M, N, V, elt)
        assert (p["path"], p["cluster"]) == ("staged", cluster), (M, N, V, elt, p)


# ------------------------------------------------------------------ (d)
def _merge(a, b):
    m = torch.maximum(a[0], b[0])
    return m, a[1] * torch.exp(a[0] - m) + b[1] * torch.exp(b[0] - m)


def _mean_z(x, tau: float):
    """z = (Σ_m x[m]·(1/M))·(1/τ) in m order: x[0]·(1/M), then one fused
    multiply-add a teacher (exact products in float64, one rounding)."""
    M = x.shape[0]
    inv_m = torch.tensor(1.0 / M, dtype=torch.float32)
    z = x[0].float() * inv_m
    for m in range(1, M):
        z = (x[m].double() * inv_m.double() + z.double()).float()
    return z * torch.tensor(1.0 / tau, dtype=torch.float32)


def ensemble_emulation(x, tau: float, **plan_kw):
    """(N, V) probabilities as kernel 2 forms them under ``ensemble_plan``."""
    M, N, V = x.shape
    p = kd_ops.ensemble_plan(M, N, V, x.element_size(), **plan_kw)
    z = _mean_z(x, tau)
    if p["path"] == "small":                     # each row's max, then its sum
        m = z.amax(-1)
        state = (m, torch.exp(z - m[:, None]).sum(-1))
    else:                                        # slices merged in rank order
        state = None
        for lo, hi in p["slices"]:
            zq = z[:, lo:hi]
            m = zq.amax(-1) if hi > lo else torch.full((N,), -1e30)
            piece = (m, torch.exp(zq - m[:, None]).sum(-1))
            state = piece if state is None else _merge(state, piece)
    return torch.exp(z - state[0][:, None]) / state[1][:, None], p


def _rows_within(out, ref, rel):
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs().amax(-1) <= rel * ref.abs().amax(-1)).all())


# (M, N, V, tau); N a multiple of the Pallas kernel's 4-row block
ENS_CASES = [(8, 64, 10, 4.0), (4, 8, 517, 2.0), (3, 4, 4096, 4.0), (2, 4, 50304, 1.0)]


@pytest.mark.parametrize("share", [None, 16 * 1024], ids=["plan", "small-share"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", ENS_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_ensemble_emulation_matches_plain_and_pallas(case, dtype, share, force_pallas):
    M, N, V, tau = case
    x = torch.from_numpy(np.random.default_rng(V).normal(0, 3, (M, N, V)).astype(np.float32))
    x = x.to(dtype)
    got, p = ensemble_emulation(x, tau, share=share)
    if share and V > kd_ops.KD_ROW_MAX_V:
        assert p["cluster"] > 1
    plain = kd_ref.ensemble_softmax_ref(x, tau)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == BF16 else jnp.float32)
    pallas = torch.from_numpy(np.asarray(jax_kd_ops.ensemble_softmax(jx, tau)))
    assert got.shape == plain.shape == pallas.shape == (N, V)
    torch.testing.assert_close(got.sum(-1), torch.ones(N), rtol=0, atol=1e-5)
    for want in (plain, pallas):     # bf16 logits too: the same f32 arithmetic on them
        assert _rows_within(got, want, 1e-5)


def test_ensemble_emulation_clusters_up_to_eight():
    """The share that gives 50,304 a cluster of 8 CTAs, each merging the
    eight states in rank order, still within 1e-5 of each row."""
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 3, (2, 4, 50304)).astype(np.float32))
    got, p = ensemble_emulation(x, 2.0, share=4 * 6300 + 16)
    assert p["cluster"] == 8
    assert _rows_within(got, kd_ref.ensemble_softmax_ref(x, 2.0), 1e-5)
    assert kd_ops.ensemble_plan(2, 4, 50304, 4, share=4 * 3200)["cluster"] == 16


# ------------------------------------------------------------------ (e)
def test_vectorized_round_with_one_storage_matches_jax(monkeypatch):
    from repro.core.tasks import classification_task as jax_classification_task
    from repro_torch.core.fedsdd import FedState
    from repro_torch.core.tasks import classification_task
    from repro_torch.distill import TeacherBank
    spec = dict(model="cnn", num_clients=8, alpha=0.5, num_train=400, num_server=256, seed=0)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, client_lr=0.05,
              server_lr=0.05, distill_steps=3, client_batch=32, rounds=2)
    jrunner = jax_make_runner("fedsdd", jax_classification_task(**spec),
                              execution="vectorized", **kw)
    jstate = jrunner.run(rounds=2)
    monkeypatch.setattr(aggregation, "_kernel_route", lambda stacked: True)
    aggregates = []
    real = ops.group_weighted_average_pytree
    monkeypatch.setattr(ops, "group_weighted_average_pytree",
                        lambda tree, w: aggregates.append(real(tree, w)) or aggregates[-1])
    task = classification_task(**spec, device="cpu")
    runner = make_runner("fedsdd", task, device="cpu", execution="vectorized", **kw)
    key = jax.random.PRNGKey(jrunner.cfg.seed)
    init = [interop.params_from_numpy(jax.tree.map(np.asarray, jrunner.task.init_fn(k)),
                                      device="cpu") for k in jax.random.split(key, 4)]
    state = runner.run(2, state=FedState(round=0, global_models=init, ensemble=TeacherBank(4, 2)))
    assert len(aggregates) == 2                  # one tree call a round
    for agg in aggregates:
        _one_storage(tree_leaves(agg))
    for m, jm in zip(state.global_models, jstate.global_models):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                                             atol=2e-4),
                     interop.params_to_numpy(m), jm)
    # models k > 0 are the last round's aggregate as it came out: views of one allocation
    assert len({x.untyped_storage().data_ptr() for x in tree_leaves(state.global_models[1])}) == 1
    assert tree_map(lambda x: x.shape, state.global_models[0]) == \
        tree_map(lambda x: x.shape, init[0])
