"""Port vs reference: the paper's ResNets and the small CNN/MLP, from the
reference's own weights (``jax.tree.map(np.asarray, init(PRNGKey))`` →
``interop.params_from_numpy``), on the same numpy batch.

f32 on both sides; logits and gradients at rtol = atol = 1e-4 (XLA's and
torch's convolutions and GroupNorm sum in different orders).  Measured on
the CPU: logits and gradients within 1.5e-6 (``-s`` prints each case's
max abs error).  Depth is cut to 8 (``ResNetConfig.reduced()``:
one block per stage, so every block kind — stride 2, projection,
identity — still runs).

The batch is seeded where no ReLU input lies within f32 noise of zero.
With ``default_rng(0)`` one pre-activation of ``s0b0``'s first norm is
1.0e-6, the two packages put it on opposite sides of the kink, and the
gradients upstream of it move by up to 1.3e-3: a property of ReLU under
reordered sums, not of the port (the logits still agree within 1e-6).

"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.resnet_cifar import get_resnet_config as jax_get_resnet_config  # noqa: E402
from repro.core import tasks as jax_tasks  # noqa: E402
from repro.models import resnet as jax_resnet  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.resnet_cifar import get_resnet_config  # noqa: E402
from repro_torch.core import tasks  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(B=4, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, B).astype(np.int32))


def _port(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _close(name, port, ref):
    port = interop.params_to_numpy(port) if not isinstance(port, torch.Tensor) \
        else port.detach().numpy()
    ref = jax.tree.map(np.asarray, ref)
    errs = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - b).max()), port, ref))
    print(f"{name}: max abs err {max(errs):.3g}")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL), port, ref)


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("model", ["resnet20", "resnet56", "wrn16-2"])
def test_resnet_logits_and_grads(model, norm):
    import dataclasses
    jcfg = dataclasses.replace(jax_get_resnet_config(model).reduced(), norm=norm)
    cfg = dataclasses.replace(get_resnet_config(model).reduced(), norm=norm)
    jparams = jax_resnet.init_resnet(jax.random.PRNGKey(1), jcfg)
    params = _port(jparams)
    x, y = _batch()
    @jax.jit
    def jax_side(p, x, y):
        vg = jax.value_and_grad(jax_resnet.resnet_loss, has_aux=True)(p, {"x": x, "y": y}, jcfg)
        return jax_resnet.resnet_logits(p, x, jcfg), vg

    jlogits, ((jloss, _), jgrads) = jax_side(jparams, jnp.asarray(x), jnp.asarray(y))
    _close(f"{model}/{norm} logits", resnet.resnet_logits(params, torch.from_numpy(x), cfg),
           jlogits)
    (loss, aux), grads = value_and_grad(resnet.resnet_loss, has_aux=True)(
        params, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert 0.0 <= float(aux["acc"]) <= 1.0
    _close(f"{model}/{norm} grads", grads, jgrads)


@pytest.mark.parametrize("net", ["cnn", "mlp"])
def test_small_net_logits_and_grads(net):
    init = {"cnn": jax_tasks._init_cnn, "mlp": jax_tasks._init_mlp}[net]
    jfn = {"cnn": jax_tasks._cnn_logits, "mlp": jax_tasks._mlp_logits}[net]
    fn = {"cnn": tasks._cnn_logits, "mlp": tasks._mlp_logits}[net]
    jparams = init(jax.random.PRNGKey(2))
    params = _port(jparams)
    x, y = _batch(B=6, seed=2)
    _close(f"{net} logits", fn(params, torch.from_numpy(x)), jfn(jparams, jnp.asarray(x)))

    def jloss(p):
        logp = jax.nn.log_softmax(jfn(p, jnp.asarray(x)))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], -1))

    _, grads = value_and_grad(lambda p: tasks._xent(fn(p, torch.from_numpy(x)),
                                                    torch.from_numpy(y)))(params)
    _close(f"{net} grads", grads, jax.grad(jloss)(jparams))


@pytest.mark.parametrize("stride,k,n", [(2, 3, 32), (2, 3, 16), (2, 1, 32), (1, 3, 8), (2, 3, 7)])
def test_conv_same_padding(stride, k, n):
    """XLA "SAME": stride 2 with a 3×3 kernel on an even input pads 0
    before and 1 after; an odd input pads 1 and 1."""
    rng = np.random.default_rng(k * n)
    x = rng.normal(0, 1, (2, n, n, 5)).astype(np.float32)
    w = rng.normal(0, 1, (k, k, 5, 7)).astype(np.float32)
    got = resnet.conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    want = jax_resnet.conv(jnp.asarray(x), jnp.asarray(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_resnet56_tree_round_trip_bit_exact():
    """A full ResNet-56 tree crosses in both directions bit for bit, and the
    port's own init draws the same tree (keys, shapes, dtypes)."""
    jparams = jax.tree.map(np.asarray, jax_resnet.init_resnet(
        jax.random.PRNGKey(0), jax_get_resnet_config("resnet56")))
    back = interop.params_to_numpy(interop.params_from_numpy(jparams, device="cpu"))
    flat_b, flat_j = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (back, jparams))
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_b, flat_j):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    gen = torch.Generator().manual_seed(0)
    mine = interop.params_to_numpy(resnet.init_resnet(gen, get_resnet_config("resnet56")))
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_m] == [p for p, _ in flat_j]
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for (_, a), (_, b) in zip(flat_m, flat_j))
    assert sum(a.size for _, a in flat_m) == 855_578
