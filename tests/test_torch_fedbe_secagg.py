"""Port vs reference: FedBE's posterior teachers and secure aggregation.

  (a) ``secure_aggregate``: the aggregate equals plain Eq. 2 at the
      reference's rtol 1e-3 / atol 1e-4 while every upload is more than 1.0
      from its raw model (the reference's ``test_aggregation.py``); the
      pairwise masks cancel in the sum, each pair's draws are antisymmetric,
      and their values match ``jax.random``'s masks in distribution (a KS
      test) — the port draws from ``seeded_normal``, never bit for bit.
  (b) ``_sample_posterior``: 2,000 samples around a weighted mean have that
      mean and the models' elementwise unbiased variance, as the
      reference's samples do (the same statistics on both).
  (c) a ``fedbe`` round (FedDF + 10 posterior samples + the main aggregate:
      8 + 10 + 1 = 19 teachers) on both engines, which agree within 2e-4.
  (d) ``fedsdd`` with ``secure_aggregation=True`` on the sequential engine
      against the JAX runner within rtol 1e-3 / atol 1e-4 after two rounds
      (the masks cancel, so both are plain Eq. 2 up to rounding); on the
      vectorized engine the flag changes nothing (the reference's caveat:
      its vectorized Eq. 2 never masks), bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

TASK = dict(model="cnn", num_clients=8, alpha=0.5, num_train=400, num_server=256, seed=0)


def small(**kw):
    base = dict(num_clients=8, participation=1.0, local_epochs=1, client_lr=0.05,
                server_lr=0.05, distill_steps=4, client_batch=32, rounds=2)
    base.update(kw)
    return base


def _models(rng, n, shape=(4, 3)):
    return [{"w": rng.normal(0, 1, shape).astype(np.float32),
             "b": rng.normal(0, 1, shape[-1:]).astype(np.float32)} for _ in range(n)]


def _torch(tree):
    return interop.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def tasks():
    return jax_classification_task(**TASK), classification_task(**TASK, device="cpu")


# -------------------------------------------------------------------- (a)
def test_secure_aggregation_hides_clients_but_preserves_sum():
    ms = _models(np.random.default_rng(3), 4)
    sizes = [5, 10, 15, 20]
    agg_sec, uploads = agg.secure_aggregate([_torch(m) for m in ms], sizes, seed=7)
    plain = agg.fedavg_aggregate([_torch(m) for m in ms], sizes)
    jplain = jagg.fedavg_aggregate([jax.tree.map(jnp.asarray, m) for m in ms], sizes)
    for k in ("w", "b"):
        np.testing.assert_allclose(agg_sec[k].numpy(), plain[k].numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(agg_sec[k].numpy(), np.asarray(jplain[k]), rtol=1e-3,
                                   atol=1e-4)
    for m, u in zip(ms, uploads):
        assert float(np.abs(u["w"].numpy() - m["w"]).max()) > 1.0, \
            "upload leaked a (nearly) raw client model"


@pytest.mark.parametrize("n", [2, 3, 5])
def test_pairwise_masks_cancel_and_are_antisymmetric(n):
    like = [_torch(m) for m in _models(np.random.default_rng(n), n, shape=(64, 9))]
    masks = agg.pairwise_masks(like, seed=11)
    for k in ("w", "b"):
        total = sum(m[k] for m in masks)
        assert float(total.abs().max()) < 1e-5
    if n == 2:            # one pair: client 1's mask is exactly minus client 0's
        assert torch.equal(masks[1]["w"], -masks[0]["w"])
    again = agg.pairwise_masks(like, seed=11)
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(masks, again))
    other = agg.pairwise_masks(like, seed=12)
    assert not torch.equal(masks[0]["w"], other[0]["w"])


def test_masks_match_reference_in_distribution():
    """Client 0 of 4 adds three pairs' N(0, 1) draws: N(0, 3) per element in
    both packages (a two-sample KS test over 4,004 values a side)."""
    from scipy.stats import ks_2samp
    ms = _models(np.random.default_rng(0), 4, shape=(1000, 4))
    port = agg.pairwise_masks([_torch(m) for m in ms], seed=5)[0]
    ref = jagg.pairwise_masks([jax.tree.map(jnp.asarray, m) for m in ms], seed=5)[0]
    x = np.concatenate([port["w"].numpy().ravel(), port["b"].numpy().ravel()])
    y = np.concatenate([np.asarray(ref["w"]).ravel(), np.asarray(ref["b"]).ravel()])
    assert ks_2samp(x, y).pvalue > 1e-3
    assert abs(x.var() - 3.0) < 0.15 and abs(x.mean()) < 0.05


# -------------------------------------------------------------------- (b)
def test_posterior_samples_have_stated_mean_and_variance(tasks):
    jtask, task = tasks
    rng = np.random.default_rng(4)
    ms = _models(rng, 6, shape=(40, 5))
    sizes = [3, 1, 4, 1, 5, 9]
    w = np.asarray(sizes, np.float64) / sum(sizes)
    mean = {k: sum(wi * m[k] for wi, m in zip(w, ms)) for k in ("w", "b")}
    var = {k: sum((m[k] - mean[k]) ** 2 for m in ms) / (len(ms) - 1) for k in ("w", "b")}
    n = 2000
    port = make_runner("fedbe", task, device="cpu")._sample_posterior(
        [_torch(m) for m in ms], sizes, n, seed=3)
    ref = jax_make_runner("fedbe", jtask)._sample_posterior(
        [jax.tree.map(jnp.asarray, m) for m in ms], sizes, n, 3)
    assert len(port) == len(ref) == n
    for k in ("w", "b"):
        for samples in (np.stack([s[k].numpy() for s in port]),
                        np.stack([np.asarray(s[k]) for s in ref])):
            sd = np.sqrt(var[k])
            # the sample mean within 5 standard errors, the sample variance
            # within 5 of its standard errors (sqrt(2/(n-1)) of var)
            assert np.all(np.abs(samples.mean(0) - mean[k]) <= 5 * sd / np.sqrt(n) + 1e-6)
            np.testing.assert_allclose(samples.var(0, ddof=1), var[k],
                                       rtol=5 * np.sqrt(2 / (n - 1)), atol=1e-6)
    assert all(s["w"].dtype == torch.float32 for s in port)


# -------------------------------------------------------------------- (c)
def _count_teachers(runner) -> list:
    counts = []
    inner = runner._distill_models

    def counting(new_globals, teachers, **kw):
        counts.append(len(teachers))
        return inner(new_globals, teachers, **kw)

    runner._distill_models = counting
    return counts


def test_fedbe_round_on_both_engines(tasks):
    _, task = tasks
    states, counts = {}, {}
    for execution in ("sequential", "vectorized"):
        runner = make_runner("fedbe", task, device="cpu", execution=execution,
                             **small(rounds=1))
        counts[execution] = _count_teachers(runner)
        states[execution] = runner.run(1)
        del runner._distill_models
    assert counts == {"sequential": [19], "vectorized": [19]}
    for a, b in zip(tree_leaves(states["sequential"].global_models[0]),
                    tree_leaves(states["vectorized"].global_models[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    assert states["sequential"].history[0]["kd_steps"] == 4


# -------------------------------------------------------------------- (d)
def test_secure_fedsdd_rounds_match_jax_runner(tasks):
    jtask, task = tasks
    kw = small(K=4, R=2, secure_aggregation=True)
    jrunner = jax_make_runner("fedsdd", jtask, **kw)
    jstate = jrunner.run(rounds=2)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [interop.params_from_numpy(jax.tree.map(np.asarray, jtask.init_fn(k)), device="cpu")
            for k in keys]
    runner = make_runner("fedsdd", task, device="cpu", **kw)
    state = runner.run(2, state=FedState(round=0, global_models=init,
                                         ensemble=TeacherBank(4, 2)))
    for m, jm in zip(state.global_models, jstate.global_models):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4),
                     interop.params_to_numpy(m), jax.tree.map(np.asarray, jm))


def test_vectorized_secure_round_is_plain_eq2(tasks):
    """The reference's vectorized ops never call ``secure_aggregate``; the
    port's do not either, so the flag leaves a vectorized round as it is."""
    _, task = tasks
    runs = [make_runner("fedsdd", task, device="cpu", execution="vectorized",
                        **small(K=2, rounds=1, secure_aggregation=flag)).run(1)
            for flag in (True, False)]
    for m, n in zip(runs[0].global_models, runs[1].global_models):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(m), tree_leaves(n)))
