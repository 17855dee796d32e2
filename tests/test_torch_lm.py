"""Port vs reference: the model zoo's training path and the LM task.

  (a) ``Model.features``, ``Model.loss`` and the gradient of the loss
      against the JAX model on reduced stablelm-3b (untied head, LayerNorm,
      SwiGLU), gemma-2b (tied head, RMSNorm, GeGLU, one KV head),
      qwen2.5-14b (QKV biases) and starcoder2-3b (sliding window 64, also
      at S 1,024 > 4·window, through the block-local ``sliding_attention``),
      from the same weights; the tied head's gradient reaches ``embed``.
  (b) ``lm_task``: client shards, server batches and ``make_batch`` are the
      reference's byte for byte; ``logits_fn == features_fn @ head_fn`` and
      both match the reference's on the reference's own init weights, which
      ``interop.params_from_numpy`` carries across tied and untied.
  (c) the client store over dict shards: ``num_examples`` and the padded
      bucket stacks of int tokens as the reference's store gives them, and a
      ``client_data`` that knows its sizes is not materialised.

Tolerances: f32 on both sides, summed in other orders: features, logits
and the loss at rtol 1e-5 (atol 1e-5 on O(1) activations); gradients at
rtol 1e-4, atol 1e-6, the grad tolerance of ``tests/test_torch_resnet.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.client_store import InMemoryStore as JaxStore  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro.data.synthetic import make_model_batch as jax_make_model_batch  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.client_store import InMemoryStore  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim.optimizers import value_and_grad  # noqa: E402

ARCHS = ["stablelm-3b", "gemma-2b", "qwen2.5-14b", "starcoder2-3b"]
TASK = dict(num_clients=3, docs_per_client=4, seq=12, server_batches_n=2, server_batch=2,
            seed=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=rtol, atol=atol),
                 interop.params_to_numpy(port), _np(ref))


def _models(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jcfg, jmodel, jparams, model, interop.params_from_numpy(_np(jparams), device="cpu")


# -------------------------------------------------------------------- (a)
@pytest.mark.parametrize("arch", ARCHS)
def test_features_loss_and_grad_match_reference(arch):
    jcfg, jmodel, jparams, model, params = _models(arch)
    assert jcfg.tie_embeddings == (arch == "gemma-2b")
    nb = jax_make_model_batch(jcfg, 2, 16, seed=3)
    nb["loss_mask"] = np.arange(16)[None, :].repeat(2, 0) >= 3
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _close(model.features(params, batch), jmodel.features(jparams, nb))
    jloss, jaux = jmodel.loss(jparams, nb)
    (loss, aux), grads = value_and_grad(model.loss, has_aux=True)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]), rtol=1e-5)
    jgrads = jax.grad(lambda p: jmodel.loss(p, nb)[0])(jparams)
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    assert float(grads["embed"].abs().max()) > 0


def test_starcoder2_gradient_past_four_windows():
    """S = 1,024 > 4·window (64): both packages' block-local sliding-window
    prefill, forward and backward."""
    jcfg, jmodel, jparams, model, params = _models("starcoder2-3b")
    assert jcfg.attn_variant == "sliding" and 1024 > 4 * jcfg.sliding_window
    nb = jax_make_model_batch(jcfg, 1, 1024, seed=6)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, nb)
    (loss, _), grads = value_and_grad(model.loss, has_aux=True)(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)


def test_tied_head_gradient_reaches_the_embedding():
    """gemma-2b's head is ``embed.T``: its gradient adds to the gather's."""
    _, _, _, model, params = _models("gemma-2b")
    nb = jax_make_model_batch(model.cfg, 2, 8, seed=4)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    _, grads = value_and_grad(lambda p, b: model.loss(p, b)[0])(params, batch)
    unused = sorted(set(range(model.cfg.vocab_size)) - set(nb["tokens"].ravel().tolist()))
    # rows no token gathers get their gradient from the head alone
    assert float(grads["embed"][unused].abs().max()) > 0


# -------------------------------------------------------------------- (b)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_task_batches_match_reference(arch):
    jtask = jax_lm_task(jax_get_config(arch).reduced(), **TASK)
    task = lm_task(get_config(arch).reduced(), **TASK, device="cpu")
    assert len(task.client_data) == len(jtask.client_data)
    for a, b in zip(task.client_data, jtask.client_data):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(task.server_batches, jtask.server_batches):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    idx = np.array([3, 0, 2])
    for k, v in task.make_batch(task.client_data[1], idx).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jtask.make_batch(
            jtask.client_data[1], idx)[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_task_functions_match_reference_on_its_weights(arch):
    """The reference task's ``init_fn(PRNGKey)`` tree, through numpy into
    the port: the same keys and shapes, and the same logits and features;
    the port's logits are its features times its head."""
    jtask = jax_lm_task(jax_get_config(arch).reduced(), **TASK)
    task = lm_task(get_config(arch).reduced(), **TASK, device="cpu")
    jparams = jtask.init_fn(jax.random.PRNGKey(2))
    params = interop.params_from_numpy(_np(jparams), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    flat = jax.tree_util.tree_flatten_with_path(interop.params_to_numpy(params))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat] == [(p, a.shape, a.dtype) for p, a in jflat]
    assert ("lm_head" in params) != (arch == "gemma-2b")
    batch, jbatch = task.server_batches[0], jtask.server_batches[0]
    with torch.no_grad():
        logits, feats = task.logits_fn(params, batch), task.features_fn(params, batch)
        w, b = task.head_fn(params)
        assert b is None and tuple(w.shape) == (get_config(arch).reduced().d_model,
                                                 logits.shape[1])
        np.testing.assert_allclose(logits.numpy(), (feats @ w).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jtask.logits_fn(jparams, jbatch)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jtask.features_fn(jparams, jbatch)),
                               rtol=1e-5, atol=1e-5)
    loss, _ = task.loss_fn(params, task.make_batch(task.client_data[0], np.arange(4)))
    jloss, _ = jtask.loss_fn(jparams, jtask.make_batch(jtask.client_data[0], np.arange(4)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_lm_task_init_fn_draws_on_the_generator():
    task = lm_task(get_config("gemma-2b").reduced(), **TASK, device="cpu")
    a = task.init_fn(torch.Generator().manual_seed(5))
    b = task.init_fn(torch.Generator().manual_seed(5))
    for x, y in zip(jax.tree.leaves(interop.params_to_numpy(a)),
                    jax.tree.leaves(interop.params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------------- (c)
def test_store_counts_and_buckets_over_dict_shards():
    """The LM task's shards are dicts: the store counts their rows and
    stacks their int tokens as the reference's store does."""
    cfg = dict(TASK, docs_per_client=3)
    jtask = jax_lm_task(jax_get_config("stablelm-3b").reduced(), **cfg)
    task = lm_task(get_config("stablelm-3b").reduced(), **cfg, device="cpu")
    # ragged shards: client 1 holds one document fewer
    jtask.client_data[1] = {k: v[:2] for k, v in jtask.client_data[1].items()}
    task.client_data[1] = {k: v[:2] for k, v in task.client_data[1].items()}
    store, jstore = InMemoryStore(task), JaxStore(jtask)
    assert [store.num_examples(c) for c in range(3)] == \
        [jstore.num_examples(c) for c in range(3)] == [3, 2, 3]
    got, want = store.get_bucket([0, 1, 2], 4), jstore.get_bucket([0, 1, 2], 4)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].shape == (3, 4, 12)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


class _SizedShards:
    """``client_data`` that knows its sizes and must not be indexed."""

    def __len__(self):
        return 3

    def num_examples(self, cid):
        return 10 + cid

    def __getitem__(self, cid):
        raise AssertionError("num_examples built a shard")


def test_store_counts_without_building_shards():
    class Task:
        client_data = _SizedShards()

    assert [InMemoryStore(Task).num_examples(c) for c in range(3)] == \
        [JaxStore(Task).num_examples(c) for c in range(3)] == [10, 11, 12]
