"""Port vs reference: the plain versions of the dense KD kernels.

The port's CPU path (``ref.py``, and the ``autograd.Function`` around
``kd_loss``) against the JAX package's ops with ``REPRO_FORCE_PALLAS=1``
(the Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
them) and against its jnp ``ref``, at the reference's sweep.  The same
numpy inputs go to both; bf16 inputs are rounded once from the same f32
values in each package (round to nearest even in both).

Tolerances are the reference's own: probabilities atol 1e-6 (f32) /
2e-3 (bf16), the loss rtol 1e-4, the gradient atol 1e-6 (a bf16
gradient, which both sides round once, also rtol 1e-2: one bf16 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kd_loss import ops as jax_ops  # noqa: E402
from repro.kernels.kd_loss import ref as jax_ref  # noqa: E402
from repro_torch.kernels.kd_loss import ops, ref  # noqa: E402

SWEEP = [(1, 4, 128), (4, 8, 1000), (8, 4, 257), (2, 16, 4096)]


@pytest.fixture()
def force_pallas(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,B,V", SWEEP)
def test_ensemble_softmax_matches_reference(K, B, V, dtype, tau, force_pallas):
    x = np.random.default_rng(K * B + V).normal(0, 3, (K, B, V)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = ops.ensemble_softmax(tx, tau).numpy()
    tol = 1e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(got, np.asarray(jax_ops.ensemble_softmax(jx, tau)), atol=tol, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_ref.ensemble_softmax_ref(jx, tau)),
                               atol=tol, rtol=0)
    many = ops.ensemble_softmax_many(tx.reshape(K, 2, B // 2, V), tau)
    np.testing.assert_array_equal(many.reshape(B, V).numpy(), got)


@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("B,V", [(B, V) for _, B, V in SWEEP])
def test_kd_loss_and_grad_match_reference(B, V, tau, force_pallas):
    rng = np.random.default_rng(B + V)
    s = (rng.normal(0, 1, (B, V)) * 3).astype(np.float32)
    t = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(0, 1, (B, V)) * 2, jnp.float32), -1))
    js, jt = jnp.asarray(s), jnp.asarray(t)
    ts = torch.from_numpy(s).requires_grad_(True)
    loss = ops.kd_loss(ts, torch.from_numpy(t), tau)
    loss.backward()
    for want in (jax_ops.kd_loss(js, jt, tau), jax_ref.kd_loss_ref(js, jt, tau)):
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    np.testing.assert_allclose(float(ref.kd_loss_ref(torch.from_numpy(s), torch.from_numpy(t), tau)),
                               float(loss), rtol=0, atol=0)
    for want in (jax.grad(lambda x: jax_ops.kd_loss(x, jt, tau))(js),
                 jax.grad(lambda x: jax_ref.kd_loss_ref(x, jt, tau))(js)):
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_kd_loss_upstream_gradient_and_bf16_student(force_pallas):
    """g ≠ 1 scales the gradient (the custom_vjp's ``* g``), and a bf16
    student gets a bf16 gradient, as the reference's backward returns."""
    rng = np.random.default_rng(7)
    s = (rng.normal(0, 1, (8, 1000)) * 3).astype(np.float32)
    t = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(0, 1, (8, 1000)), jnp.float32), -1))
    js, ts = _pair(s, "bfloat16")
    ts.requires_grad_(True)
    (2.5 * ops.kd_loss(ts, torch.from_numpy(t), 4.0)).backward()
    want = jax.grad(lambda x: 2.5 * jax_ops.kd_loss(x, jnp.asarray(t), 4.0))(js)
    assert ts.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(ts.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=1e-2)


def test_kd_loss_zero_when_student_equals_teacher():
    s = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (4, 100)).astype(np.float32))
    assert float(ops.kd_loss(s, torch.softmax(s / 4.0, -1), 4.0)) < 1e-5


def test_teacher_gets_no_gradient():
    s = torch.randn(4, 10, requires_grad=True)
    t = torch.softmax(torch.randn(4, 10), -1).requires_grad_(True)
    ops.kd_loss(s, t, 2.0).backward()
    assert s.grad is not None and t.grad is None
