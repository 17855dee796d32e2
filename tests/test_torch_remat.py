"""``remat`` on the port's model and train step against the reference's
(``jax.checkpoint`` of each superblock, or the
``dots_with_no_batch_dims_saveable`` policy under ``"dots"``).

For a dense GQA model (qwen2.5-14b) and a MoE + MLA one
(deepseek-v2-lite-16b) at ``reduced()`` size, f32, from the reference's
weights (``interop``): the port's loss and gradients under ``remat``
False, True and ``"dots"`` are equal to each other bit for bit (a
recomputation repeats the same CPU arithmetic), and each holds the
reference's ``model.loss(..., remat=...)`` and ``jax.grad`` at
``tests/test_torch_model.py``'s tolerance.  Both packages' train steps
default to ``remat=True``, and the port's default really recomputes.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ARCHS = ["qwen2.5-14b", "deepseek-v2-lite-16b"]
REMATS = [False, True, "dots"]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module, as the repo's other model
    files: the same arithmetic, much faster beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def case(request, _one_thread):
    """The two packages' models from one set of weights, one batch, and
    each package's (loss, gradient leaves) under every ``remat``."""
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_config(request.param).reduced())
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    nb = make_model_batch(jcfg, 2, 16, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    port, ref = {}, {}
    for remat in REMATS:
        loss, grads = value_and_grad(lambda p, b, r=remat: model.loss(p, b, remat=r)[0])(
            params, batch)
        port[remat] = (loss, interop.params_to_numpy(grads))
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, r=remat: jmodel.loss(p, jbatch, remat=r)[0]))(jparams)
        ref[remat] = (jl, jax.tree.map(np.asarray, jg))
    return port, ref


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_port_remat_is_bit_for_bit(case, remat):
    """Recomputing a superblock repeats its arithmetic exactly."""
    port, _ = case
    loss, grads = port[remat]
    loss0, grads0 = port[False]
    assert torch.equal(loss, loss0)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(grads), _leaves(grads0)))


@pytest.mark.parametrize("remat", REMATS)
def test_remat_matches_reference(case, remat):
    port, ref = case
    loss, grads = port[remat]
    jl, jg = ref[remat]
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    flat_p = jax.tree_util.tree_flatten_with_path(grads)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)


def test_train_step_defaults_to_remat():
    """Both packages' train steps recompute by default; the port's default
    runs more products than ``remat=False`` (the recomputed forward), with
    the same loss and new weights."""
    assert inspect.signature(steps.make_train_step).parameters["remat"].default is True
    assert inspect.signature(jsteps.make_train_step).parameters["remat"].default is True
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
                self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = get_config("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             make_model_batch(jax_get_config("qwen2.5-14b").reduced(), 2, 16, seed=4).items()}
    out = {}
    for key, fn in (("default", steps.make_train_step(model)),
                    ("off", steps.make_train_step(model, remat=False))):
        with Products() as count:
            loss, new = fn(params, batch)
        out[key] = (count.n, loss, tree_leaves(new))
    assert out["default"][0] > out["off"][0]
    assert torch.equal(out["default"][1], out["off"][1])
    assert all(torch.equal(a, b) for a, b in zip(out["default"][2], out["off"][2]))
