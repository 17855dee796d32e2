"""Port vs reference: configs, synthetic data and the shared layers.

Inputs are made with numpy from a seed and fed to both packages; f32
throughout, so only the order of summation differs (rtol = atol = 1e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCHS = ["qwen2.5-14b", "gemma-2b", "stablelm-3b", "deepseek-v2-lite-16b",
         "llama4-maverick-400b-a17b", "hubert-xlarge", "llava-next-mistral-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_reference(arch):
    port, ref = get_config(arch), jax_get_config(arch)
    for cfg_p, cfg_r in ((port, ref), (port.reduced(), ref.reduced())):
        a, b = dataclasses.asdict(cfg_p), dataclasses.asdict(cfg_r)
        assert a == b
        assert cfg_p.pdtype == getattr(torch, cfg_r.param_dtype)
        assert cfg_p.num_params() == cfg_r.num_params()


def test_unported_arch_is_not_registered():
    """Every assigned architecture is registered (none is left to port);
    a name that is not one raises ``KeyError``."""
    from repro_torch.configs import ASSIGNED_ARCHS
    assert all(get_config(arch).name == arch for arch in ASSIGNED_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama5-unknown")


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_are_byte_identical(seed):
    cfg = get_config("qwen2.5-14b").reduced()
    a = synthetic.make_model_batch(cfg, 4, 9, seed=seed)
    b = jax_synth.make_model_batch(jax_get_config("qwen2.5-14b").reduced(), 4, 9, seed=seed)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def _cfg(**kw):
    return dataclasses.replace(get_config("qwen2.5-14b").reduced(), **kw)


@pytest.mark.parametrize("variant", ["rmsnorm", "layernorm"])
def test_apply_norm(variant):
    cfg = _cfg(norm_variant=variant)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, cfg.d_model).astype(np.float32),
         "bias": rng.normal(0, 0.1, cfg.d_model).astype(np.float32)}
    ref = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), cfg)
    port = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    _close(port, ref)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    ref = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    port = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(port, ref)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(variant):
    cfg = _cfg(mlp_variant=variant)
    rng = np.random.default_rng(2)
    D, F = cfg.d_model, cfg.d_ff
    x = rng.normal(0, 1, (2, 3, D)).astype(np.float32)
    p = {"w_in": rng.normal(0, D ** -0.5, (D, F)).astype(np.float32),
         "w_gate": rng.normal(0, D ** -0.5, (D, F)).astype(np.float32),
         "w_out": rng.normal(0, F ** -0.5, (F, D)).astype(np.float32)}
    ref = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), cfg)
    port = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    _close(port, ref)


def test_init_scales_follow_reference():
    """dense_init / embed_init draw N(0, scale²) on the generator's device."""
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 256, 512, torch.float32, stack=(3,))
    e = layers.embed_init(gen, 1000, 64, torch.float32)
    assert w.shape == (3, 256, 512) and e.shape == (1000, 64)
    assert abs(w.std().item() - 256 ** -0.5) < 2e-3
    assert abs(e.std().item() - 0.02) < 1e-3
