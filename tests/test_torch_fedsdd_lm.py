"""Port vs reference: FedSDD rounds on the LM task with Flash-KD.

Two rounds of ``fedsdd`` (K=2, R=1, the ``small()`` settings of
``tests/test_head_fusion.py``) on the reduced LM task, from the JAX
runner's init weights, against the JAX runner with the same options:
``kd_kernel="flash"`` with an f32 and with the default bf16 teacher cache,
and ``kd_head_fusion=True``, each on the sequential and the vectorized
engine; the head-fused run also on gemma-2b's tied head.  Every global
model and the KD losses within 2e-4, the reference's end-to-end tolerance.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import lm_task as jax_lm_task  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import lm_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402

ATOL = RTOL = 2e-4
TASK = dict(num_clients=4, docs_per_client=2, seq=8, server_batches_n=2, server_batch=2)
OPTIONS = {
    "flash_f32": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
    "flash_bf16": dict(kd_kernel="flash"),
    "head_fused": dict(kd_kernel="flash", kd_head_fusion=True),
}


def small(**kw):
    base = dict(num_clients=4, participation=1.0, local_epochs=1, client_lr=0.02,
                client_batch=2, distill_steps=3, server_lr=0.02, K=2, R=1)
    base.update(kw)
    return base


_TASKS: dict = {}


def _tasks(arch):
    if arch not in _TASKS:
        _TASKS[arch] = (jax_lm_task(jax_get_config(arch).reduced(), **TASK),
                        lm_task(get_config(arch).reduced(), **TASK, device="cpu"))
    return _TASKS[arch]


@pytest.mark.parametrize("arch,option,execution", [
    *[("stablelm-3b", o, e) for o in OPTIONS for e in ("sequential", "vectorized")],
    ("gemma-2b", "head_fused", "sequential"),
])
def test_two_lm_rounds_match_jax_runner(arch, option, execution):
    jtask, task = _tasks(arch)
    kw = small(execution=execution, **OPTIONS[option])
    jrunner = jax_make_runner("fedsdd", jtask, **kw)
    jstate = jrunner.run(rounds=2)
    keys = jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), jrunner.cfg.K)
    init = [interop.params_from_numpy(jax.tree.map(np.asarray, jtask.init_fn(k)), device="cpu")
            for k in keys]
    runner = make_runner("fedsdd", task, device="cpu", **kw)
    assert runner._kd_pipeline().head_fused == (option == "head_fused")
    state = FedState(round=0, global_models=init, ensemble=TeacherBank(2, 1))
    state = runner.run(2, state=state)
    assert state.round == jstate.round == 2
    for m, jm in zip(state.global_models, jstate.global_models):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL),
                     interop.params_to_numpy(m), jax.tree.map(np.asarray, jm))
    for rec, jrec in zip(state.history, jstate.history):
        assert rec["kd_steps"] == jrec["kd_steps"] == 3
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=RTOL, atol=ATOL)


def test_flash_cache_is_compressed_and_matches_reference():
    """The flash cache: bf16 mean logits (half the dense f32 bytes) and its
    f32 normaliser, against the reference pipeline's cache."""
    from repro.distill import KDPipeline as JaxKDPipeline
    from repro_torch.distill import KDPipeline
    jtask, task = _tasks("gemma-2b")
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    jteachers = [jtask.init_fn(k) for k in keys]
    teachers = [interop.params_from_numpy(jax.tree.map(np.asarray, m), device="cpu")
                for m in jteachers]
    jstack = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jteachers)
    kw = dict(steps=1, lr=0.1, temperature=4.0)
    pipe = KDPipeline(task.logits_fn, kd_kernel="flash", device="cpu", **kw)
    jpipe = JaxKDPipeline(jtask.logits_fn, kd_kernel="flash", **kw)
    zt, lse = pipe.precompute_cache(teachers, pipe.batches_for(task.server_batches))
    jzt, jlse = jpipe.precompute_cache(jstack, jpipe.batches_for(jtask.server_batches))
    assert zt.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # f32 means a few ulps apart round to the same bf16 value or to its
    # neighbour: one bf16 ulp, at most 2^-7 of the value
    np.testing.assert_allclose(zt.float().numpy(), np.asarray(jzt, np.float32), rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)
    dense = KDPipeline(task.logits_fn, device="cpu", **kw)
    batches = pipe.batches_for(task.server_batches)
    assert pipe.cache_nbytes(teachers, batches) == jpipe.cache_nbytes(
        jstack, jpipe.batches_for(jtask.server_batches))
    assert 2 * (pipe.cache_nbytes(teachers, batches) - lse.numel() * 4) == \
        dense.cache_nbytes(teachers, batches)
