"""``repro_torch.launch.steps`` against ``repro.launch.steps``: the skip
matrix for every assigned architecture × input shape, the input and FedSDD
round specs at full size (``meta`` tensors against ``ShapeDtypeStruct``s:
both sides abstract, nothing allocated), and one train, prefill and serve
step at ``reduced()`` sizes from the reference's weights, at
``tests/test_torch_model.py``'s tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.data.synthetic import make_model_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module: the same arithmetic, and much
    faster where several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, path=()):
    """{path: (shape, dtype name)} of a spec tree of either package."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, path + (i,)).items()}
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    return {path: (tuple(tree.shape), np.dtype(tree.dtype).name)}


def test_shapes_are_the_references():
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in INPUT_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_supported_matches_reference(arch):
    for name in INPUT_SHAPES:
        assert steps.supported(get_config(arch), INPUT_SHAPES[name]) == \
            jsteps.supported(jax_get_config(arch), JAX_SHAPES[name])
        cfg = steps.config_for_shape(get_config(arch), INPUT_SHAPES[name])
        jcfg = jsteps.config_for_shape(jax_get_config(arch), JAX_SHAPES[name])
        assert (cfg.attn_variant, cfg.sliding_window) == (jcfg.attn_variant, jcfg.sliding_window)


def _by_config(module, monkeypatch):
    """``module.param_specs`` once per configuration (the shapes of one
    architecture share it, bar long_500k's sliding variant)."""
    seen, orig = {}, module.param_specs

    def param_specs(model):
        key = repr(model.cfg)
        if key not in seen:
            seen[key] = orig(model)
        return seen[key]
    monkeypatch.setattr(module, "param_specs", param_specs)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch, monkeypatch):
    _by_config(steps, monkeypatch)
    _by_config(jsteps, monkeypatch)
    for name in INPUT_SHAPES:
        if not steps.supported(get_config(arch), INPUT_SHAPES[name])[0]:
            continue
        got = _flat(steps.input_specs(get_config(arch), INPUT_SHAPES[name]))
        ref = _flat(jsteps.input_specs(jax_get_config(arch), JAX_SHAPES[name]))
        assert got == ref, f"{arch} {name}"


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "hubert-xlarge", "llava-next-mistral-7b"])
def test_fedsdd_round_specs_match_reference(arch):
    kw = dict(K=2, clients_per_group=4, server_batch=8)
    got = _flat(steps.fedsdd_round_specs(get_config(arch), INPUT_SHAPES["train_4k"], **kw))
    ref = _flat(jsteps.fedsdd_round_specs(jax_get_config(arch), JAX_SHAPES["train_4k"], **kw))
    assert got == ref
    with pytest.raises(ValueError, match="period_mult"):
        steps.fedsdd_round_specs(get_config(arch), INPUT_SHAPES["train_4k"], period_mult=2)


@pytest.fixture(scope="module", params=["qwen2.5-14b", "gemma-2b"])
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_config(request.param).reduced())
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, model, params


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_train_step_matches_reference(pair):
    jcfg, jmodel, jparams, model, params = pair
    b = make_model_batch(jcfg, 2, 16, seed=3)
    jloss, jnew = jax.jit(jsteps.make_train_step(jmodel, lr=0.1))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    loss, new = steps.make_train_step(model, lr=0.1)(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(loss, jloss)
    for a, r in zip(interop.params_to_numpy(new).values(), jax.tree.map(np.asarray, jnew).values()):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(r)):
            np.testing.assert_allclose(x, y, **TOL)


def test_prefill_and_serve_steps_match_reference(pair):
    """The prefill step over 12 tokens, then the serve step at position 10
    (its token rewrites the cache row there), as ``test_torch_model.py``
    drives ``decode_step``."""
    jcfg, jmodel, jparams, model, params = pair
    toks = make_model_batch(jcfg, 2, 12, seed=4)["tokens"]
    jl, jc = jsteps.make_prefill_step(jmodel)(jparams, {"tokens": jnp.asarray(toks)})
    pl, pc = steps.make_prefill_step(model)(params, {"tokens": torch.from_numpy(toks)})
    _close(pl, jl)
    tok = toks[:, 10:11]
    jl, _ = jsteps.make_serve_step(jmodel)(jparams, jnp.asarray(tok), jc, 10)
    pl, _ = steps.make_serve_step(model)(params, torch.from_numpy(tok), pc, 10)
    _close(pl, jl)
