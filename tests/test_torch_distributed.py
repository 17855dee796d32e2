"""``repro_torch.core.distributed`` against ``repro.core.distributed``: the
FedSDD round and the distillation step as plain tensor functions, on the
same numpy inputs through both packages.

  (a) The reference's three tests (``tests/test_distributed.py``) on its
      tiny linear-softmax model, each against the JAX function and at the
      reference's tolerances (rtol 2e-4, atol 1e-5): the round equals the
      JAX round (and the sequential oracle the reference builds); KD
      touches the main model alone (``server_lr`` 0.5 against 0); ten
      distillation steps equal the JAX ones and move the student toward
      the ensemble.
  (b) A reduced gemma-2b round (K=2, N=2, 2 local steps) from the
      reference's weights through ``interop.params_from_numpy``: every
      model within 2e-4 of the JAX round's.  On the CPU the KD wrappers
      run their plain versions; the card holds the kernels against them
      (``chip_smoke.py`` phase 36).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.distributed import make_distill_step_fn as jax_distill_step  # noqa: E402
from repro.core.distributed import make_fedsdd_round_fn as jax_round_fn  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.kernels.kd_loss import ref as jax_kd_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.distributed import make_distill_step_fn, make_fedsdd_round_fn  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

REF_TOL = dict(rtol=2e-4, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


# tiny linear-softmax "model", in both packages
def jax_loss(params, batch):
    logp = jax.nn.log_softmax(batch["x"] @ params["w"])
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][..., None], -1))


def jax_logits(params, batch):
    return batch["x"] @ params["w"]


def port_loss(params, batch):
    logp = torch.log_softmax(batch["x"] @ params["w"], -1)
    return -torch.gather(logp, -1, batch["y"][..., None].long()).mean()


def port_logits(params, batch):
    return batch["x"] @ params["w"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module: the same arithmetic, and much
    faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_params(seed, d=5, v=3):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (d, v)))


def make_batches(K, N, B, d=5, v=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (K, N, B, d)).astype(np.float32),
            "y": rng.integers(0, v, (K, N, B)).astype(np.int32)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _both_rounds(stacked, cb, weights, server_batch, **kw):
    got = make_fedsdd_round_fn(port_loss, port_logits, **kw)(
        {"w": torch.from_numpy(stacked)}, _port(cb), torch.from_numpy(weights),
        _port(server_batch))
    want = jax.jit(jax_round_fn(jax_loss, jax_logits, **kw))(
        {"w": jnp.asarray(stacked)}, _jax(cb), jnp.asarray(weights), _jax(server_batch))
    return got["w"].numpy(), np.asarray(want["w"])


@pytest.mark.parametrize("local_steps", [1, 2])
def test_round_step_matches_jax_and_sequential_reference(local_steps):
    K, N, B = 2, 3, 4
    lr_c, lr_s, tau = 0.3, 0.1, 2.0
    globals_list = [make_params(k) for k in range(K)]
    stacked = np.stack(globals_list)
    cb = make_batches(K, N, B)
    weights = np.asarray([[1.0, 2.0, 3.0], [1.0, 1.0, 2.0]], np.float32)
    rng = np.random.default_rng(9)
    server_batch = {"x": rng.normal(0, 1, (8, 5)).astype(np.float32)}
    got, want = _both_rounds(stacked, cb, weights, server_batch, client_lr=lr_c,
                             server_lr=lr_s, temperature=tau, local_steps=local_steps)
    np.testing.assert_allclose(got, want, **REF_TOL)
    if local_steps > 1:
        return
    # the reference's sequential oracle
    new_globals = []
    for k in range(K):
        client_ws = []
        for n in range(N):
            batch = {"x": jnp.asarray(cb["x"][k, n]), "y": jnp.asarray(cb["y"][k, n])}
            g = jax.grad(jax_loss)({"w": jnp.asarray(globals_list[k])}, batch)
            client_ws.append(globals_list[k] - lr_c * np.asarray(g["w"]))
        w = weights[k] / weights[k].sum()
        new_globals.append(sum(wi * x for wi, x in zip(w, client_ws)))
    sb = jnp.asarray(server_batch["x"])
    probs = jax_kd_ref.ensemble_softmax_ref(jnp.stack([sb @ m for m in new_globals]), tau)
    gmain = jax.grad(lambda p: jax_kd_ref.kd_loss_ref(sb @ p, probs, tau))(
        jnp.asarray(new_globals[0]))
    np.testing.assert_allclose(got[0], new_globals[0] - lr_s * np.asarray(gmain), **REF_TOL)
    np.testing.assert_allclose(got[1], new_globals[1], **REF_TOL)


def test_non_main_models_not_distilled():
    """Diversity: stacked[1:] equals plain aggregation (KD touches index 0
    only), in the port as in the reference."""
    K, N, B = 3, 2, 4
    stacked = np.stack([make_params(k + 10) for k in range(K)])
    cb = make_batches(K, N, B, seed=4)
    weights = np.ones((K, N), np.float32)
    server_batch = {"x": np.random.default_rng(1).normal(0, 1, (4, 5)).astype(np.float32)}
    out1, want1 = _both_rounds(stacked, cb, weights, server_batch, server_lr=0.5)
    out0, want0 = _both_rounds(stacked, cb, weights, server_batch, server_lr=0.0)
    np.testing.assert_allclose(out1, want1, **REF_TOL)
    np.testing.assert_allclose(out0, want0, **REF_TOL)
    np.testing.assert_array_equal(out1[1:], out0[1:])
    assert np.abs(out1[0] - out0[0]).max() > 1e-6


def test_distill_step_fn_matches_jax_and_moves_student_toward_ensemble():
    teachers = np.stack([make_params(s) for s in (1, 2, 3)])
    student = make_params(42)
    batch = {"x": np.random.default_rng(0).normal(0, 1, (16, 5)).astype(np.float32)}
    step = make_distill_step_fn(port_logits, server_lr=0.5, temperature=1.0)
    jstep = jax.jit(jax_distill_step(jax_logits, server_lr=0.5, temperature=1.0))
    sb = jnp.asarray(batch["x"])
    target = jax_kd_ref.ensemble_softmax_ref(jnp.stack([sb @ t for t in teachers]), 1.0)

    def kl(p):
        return float(jax_kd_ref.kd_loss_ref(sb @ jnp.asarray(p), target, 1.0))

    before = kl(student)
    p, jp = {"w": torch.from_numpy(student)}, {"w": jnp.asarray(student)}
    for _ in range(10):
        p = step(p, {"w": torch.from_numpy(teachers)}, _port(batch))
        jp = jstep(jp, {"w": jnp.asarray(teachers)}, _jax(batch))
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), **REF_TOL)
    assert kl(p["w"].numpy()) < before


# ------------------------------------------------------------------- (b)
def test_gemma_reduced_round_matches_jax():
    jcfg = jax_get_config("gemma-2b").reduced()
    jmodel = jax_build_model(jcfg)
    model = build_model(get_config("gemma-2b").reduced())
    K, N, B, S = 2, 2, 2, 16
    jparams = [jmodel.init(k) for k in jax.random.split(jax.random.PRNGKey(0), K)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
    stack = interop.params_from_numpy(jax.tree.map(np.asarray, jstack), device="cpu")
    batches = [make_model_batch(jcfg, B, S, seed=10 + i) for i in range(K * N)]
    cb = {k: np.stack([b[k] for b in batches]).reshape((K, N) + batches[0][k].shape)
          for k in ("tokens", "labels")}
    server = {"tokens": make_model_batch(jcfg, 4, S, seed=99)["tokens"]}
    weights = np.asarray([[3.0, 1.0], [2.0, 2.0]], np.float32)
    kw = dict(client_lr=0.1, server_lr=0.1, temperature=4.0, local_steps=2)
    want = jax.jit(jax_round_fn(lambda p, b: jmodel.loss(p, b)[0],
                                lambda p, b: jmodel.logits(p, b)[0], **kw))(
        jstack, _jax(cb), jnp.asarray(weights), _jax(server))
    got = make_fedsdd_round_fn(lambda p, b: model.loss(p, b)[0],
                               lambda p, b: model.logits(p, b)[0], **kw)(
        stack, _port(cb), torch.from_numpy(weights), _port(server))
    got_np = interop.params_to_numpy(got)
    flat_got = jax.tree_util.tree_flatten_with_path(got_np)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0])
    assert len(flat_got) == len(flat_want)
    moved = 0.0
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path], **MODEL_TOL, err_msg=str(path))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstack))[0]:
        moved = max(moved, float(np.abs(flat_want[path] - leaf).max()))
    assert moved > 1e-3            # the round changed the models
