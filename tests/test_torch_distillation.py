"""The legacy host-loop KD oracle (``repro_torch/core/distillation.py``)
against the JAX package's ``repro/core/distillation.py``, and the runner's
``kd_pipeline="legacy"`` and ``ensemble_eval_fn``.

  (a) every function of the module on the same numpy inputs (a linear
      model, whose ``features_fn``/``head_fn`` split also drives the
      head-fused path): rtol 1e-5, as ``tests/test_distillation.py``, with
      atol 1e-6 where a value can be near 0; the predictions equal;
  (b) the reference's own assertions, on the port: ``distill`` lowers the
      KD loss and moves the student toward the ensemble; the teachers are
      left bit for bit as they were;
  (c) two FedSDD rounds (K=4, R=2, MLP task) with ``kd_pipeline="legacy"``
      from the JAX init weights against the JAX runner's legacy rounds, and
      against the port's fused pipeline, at 2e-4 (the runner-parity
      tolerance of ``tests/test_torch_fedsdd.py``), on both engines;
  (d) ``ensemble_eval_fn`` (paper Table 5's K·R ensemble) against the JAX
      runner's on one state built in both packages from the same weights:
      the predictions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distillation as jdist  # noqa: E402
from repro.core.fedsdd import FedState as JaxFedState  # noqa: E402
from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.distill import TeacherBank as JaxTeacherBank  # noqa: E402
from repro.optim.optimizers import sgd as jax_sgd  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import distillation as dist  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.data.synthetic import SyntheticClassification  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_stack  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
RUN_TOL = 2e-4
TASK = dict(model="mlp", num_clients=8, alpha=0.5, num_train=320, num_server=256, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny CPU models run faster on one thread, and much faster where
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def linear_logits(p, b):
    return b["x"] @ p["w"]


def features(p, b):
    return b["x"]


def head(p):
    return p["w"], None


def _teacher(seed, d=6, v=4):
    return {"w": np.random.default_rng(seed).normal(0, 1, (d, v)).astype(np.float32)}


def _batch(seed, n=16, d=6):
    return {"x": np.random.default_rng(seed).normal(0, 1, (n, d)).astype(np.float32)}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------------- (a)
def test_ensemble_functions_match_reference():
    ts = [_teacher(i) for i in range(4)]
    b = _batch(1)
    tt, jt, tb, jb = [_t(t) for t in ts], [_j(t) for t in ts], _t(b), _j(b)
    _close(dist.ensemble_logits(tt, tb, linear_logits),
           jdist.ensemble_logits(jt, jb, linear_logits))
    _close(dist.ensemble_probs(tt, tb, linear_logits, 4.0),
           jdist.ensemble_probs(jt, jb, linear_logits, 4.0))
    stacked, jstacked = tree_stack(tt), jax.tree.map(lambda *x: jnp.stack(x), *jt)
    _close(dist.stacked_teacher_logits(stacked, tb, linear_logits),
           jdist.stacked_teacher_logits(jstacked, jb, linear_logits))
    _close(dist.ensemble_probs_stacked(stacked, tb, linear_logits, 4.0),
           jdist.ensemble_probs_stacked(jstacked, jb, linear_logits, 4.0))
    _close(dist.ensemble_mean_logits_stacked(stacked, tb, linear_logits),
           jdist.ensemble_mean_logits_stacked(jstacked, jb, linear_logits))
    np.testing.assert_array_equal(dist.ensemble_predict(tt, tb, linear_logits).numpy(),
                                  np.asarray(jdist.ensemble_predict(jt, jb, linear_logits)))
    probs = dist.ensemble_probs(tt, tb, linear_logits, 4.0)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=RTOL)


def test_precast_upcasts_bf16_members_once():
    t = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "i": torch.ones(2, dtype=torch.int32)}
    (c,) = dist.precast_teachers([t])
    assert c["w"].dtype == torch.float32 and c["i"].dtype == torch.int32
    f = {"w": torch.ones(3, 2)}
    assert dist.precast_teachers([f])[0]["w"] is f["w"]


KD_STEP = {"dense": dict(kd_kernel="dense"), "flash": dict(kd_kernel="flash"),
           "head-fused": dict(kd_kernel="flash", head_fusion=True)}


@pytest.mark.parametrize("path", list(KD_STEP))
def test_kd_step_matches_reference(path):
    ts, s, b = [_teacher(i) for i in range(3)], _teacher(9), _batch(2)
    opts = dict(KD_STEP[path], features_fn=features, head_fn=head)
    if path == "dense":
        row = dist.ensemble_probs([_t(t) for t in ts], _t(b), linear_logits, 3.0)
        jrow = jdist.ensemble_probs([_j(t) for t in ts], _j(b), linear_logits, 3.0)
    else:
        row = dist.ensemble_logits([_t(t) for t in ts], _t(b), linear_logits)
        jrow = jdist.ensemble_logits([_j(t) for t in ts], _j(b), linear_logits)
    step = dist.make_kd_step(linear_logits, sgd(0.5, momentum=0.9), 3.0, **opts)
    jstep = jdist.make_kd_step(linear_logits, jax_sgd(0.5, momentum=0.9), 3.0, **opts)
    st, opt = _t(s), sgd(0.5, momentum=0.9).init(_t(s))
    jst, jopt = _j(s), jax_sgd(0.5, momentum=0.9).init(_j(s))
    for _ in range(3):
        st, opt, loss = step(st, opt, _t(b), row)
        jst, jopt, jloss = jstep(jst, jopt, _j(b), jrow)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    _close(st, jst)
    with pytest.raises(ValueError, match="kd_kernel"):
        dist.make_kd_step(linear_logits, sgd(0.1), 1.0, kd_kernel="x")


@pytest.mark.parametrize("path", list(KD_STEP))
@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
def test_distill_matches_reference(path, stacked):
    ts, s = [_teacher(i) for i in range(3)], _teacher(99)
    batches = [_batch(i) for i in range(3)]
    tt = tree_stack([_t(t) for t in ts]) if stacked else [_t(t) for t in ts]
    jt = ([_j(t) for t in ts] if not stacked
          else jax.tree.map(lambda *x: jnp.stack(x), *[_j(t) for t in ts]))
    kw = dict(steps=7, lr=0.5, temperature=2.0, stacked_teachers=stacked,
              features_fn=features, head_fn=head, **KD_STEP[path])
    out, info = dist.distill(_t(s), tt, [_t(b) for b in batches], linear_logits, **kw)
    jout, jinfo = jdist.distill(_j(s), jt, [_j(b) for b in batches], linear_logits, **kw)
    _close(out, jout)
    for k in ("kd_loss_first", "kd_loss_last"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=RTOL, atol=ATOL)
    assert info["kd_steps"] == jinfo["kd_steps"] == 7


# ------------------------------------------------------------------- (b)
def test_distill_reduces_kd_loss_and_converges_toward_teacher():
    ts = [_t(_teacher(i)) for i in range(2)]
    student = _t(_teacher(99))
    new_student, info = dist.distill(student, ts, [_t(_batch(i)) for i in range(3)],
                                     linear_logits, steps=60, lr=0.5, temperature=2.0)
    assert info["kd_loss_last"] < info["kd_loss_first"]
    b = _t(_batch(7))
    tgt = dist.ensemble_probs(ts, b, linear_logits, 1.0)

    def tv(p):
        return float((torch.softmax(linear_logits(p, b), -1) - tgt).abs().mean())

    assert tv(new_student) < tv(student)


def test_distill_teachers_frozen():
    ts = [_t(_teacher(i)) for i in range(2)]
    snapshot = [t["w"].clone() for t in ts]
    dist.distill(_t(_teacher(5)), ts, [_t(_batch(0))], linear_logits, steps=5, lr=0.5)
    for t, s in zip(ts, snapshot):
        assert torch.equal(t["w"], s)


# ------------------------------------------------------------------- (c)
def small(**kw):
    base = dict(num_clients=8, participation=1.0, local_epochs=1, client_lr=0.05,
                server_lr=0.05, distill_steps=4, client_batch=32, K=4, R=2)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def tasks():
    return jax_classification_task(**TASK), classification_task(**TASK, device="cpu")


@pytest.fixture(scope="module")
def jax_legacy(tasks):
    """The JAX runner's two legacy rounds and its init weights as numpy."""
    jtask, _ = tasks
    jrunner = jax_make_runner("fedsdd", jtask, kd_pipeline="legacy", **small())
    init = [jax.tree.map(np.asarray, jtask.init_fn(k))
            for k in jax.random.split(jax.random.PRNGKey(jrunner.cfg.seed), 4)]
    return jrunner.run(rounds=2), init


def _port_run(task, init, **kw):
    runner = make_runner("fedsdd", task, device="cpu", **small(**kw))
    state = FedState(round=0, global_models=[interop.params_from_numpy(m, device="cpu")
                                             for m in init],
                     ensemble=TeacherBank(4, 2))
    return runner.run(2, state=state)


def _models_close(a, b):
    for m, jm in zip(a, b):
        for x, y in zip(interop.params_to_numpy(m).values(), jax.tree.leaves(jm)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=RUN_TOL, atol=RUN_TOL)


@pytest.mark.parametrize("execution", ["sequential", "vectorized"])
def test_legacy_rounds_match_jax_and_the_fused_pipeline(tasks, jax_legacy, execution):
    _, task = tasks
    jstate, init = jax_legacy
    legacy = _port_run(task, init, kd_pipeline="legacy", execution=execution)
    fused = _port_run(task, init, kd_pipeline="fused", execution=execution)
    _models_close(legacy.global_models, jstate.global_models)
    _models_close(legacy.global_models,
                  [jax.tree.map(np.asarray, interop.params_to_numpy(m))
                   for m in fused.global_models])
    for rec, jrec, frec in zip(legacy.history, jstate.history, fused.history):
        for k in ("kd_loss_first", "kd_loss_last"):
            np.testing.assert_allclose(rec[k], jrec[k], rtol=RUN_TOL, atol=RUN_TOL)
            np.testing.assert_allclose(rec[k], frec[k], rtol=RUN_TOL, atol=RUN_TOL)
        assert rec["kd_steps"] == jrec["kd_steps"] == 4


# ------------------------------------------------------------------- (d)
def test_ensemble_eval_fn_matches_jax_runner(tasks):
    jtask, task = tasks
    rng = np.random.default_rng(11)
    rounds = []
    for _ in range(3):        # three pushes into a ring of R = 2
        rounds.append([jax.tree.map(
            lambda x: (np.asarray(x) + rng.normal(0, 0.05, np.shape(x))).astype(np.float32),
            jtask.init_fn(jax.random.PRNGKey(len(rounds) * 4 + k))) for k in range(4)])
    bank, jbank = TeacherBank(4, 2), JaxTeacherBank(4, 2)
    for t, models in enumerate(rounds, start=1):
        bank.push(t, [interop.params_from_numpy(m, device="cpu") for m in models])
        jbank.push(t, [_j(m) for m in models])
    gm = [interop.params_from_numpy(m, device="cpu") for m in rounds[-1]]
    state = FedState(round=3, global_models=gm, ensemble=bank)
    jstate = JaxFedState(round=3, global_models=[_j(m) for m in rounds[-1]], ensemble=jbank)
    fn = make_runner("fedsdd", task, device="cpu", **small()).ensemble_eval_fn(state)
    jfn = jax_make_runner("fedsdd", jtask, **small()).ensemble_eval_fn(jstate)
    x_te, y_te = SyntheticClassification(num_train=320, num_server=256, seed=0).test()
    pred = fn({"x": torch.from_numpy(x_te[:500])}).numpy()
    jpred = np.asarray(jfn({"x": jnp.asarray(x_te[:500])}))
    np.testing.assert_array_equal(pred, jpred)
    # the ensemble holds copies: a later push does not move its predictions
    bank.push(4, gm)
    np.testing.assert_array_equal(fn({"x": torch.from_numpy(x_te[:500])}).numpy(), pred)
    # with an empty ring it is the K global models' ensemble
    empty = FedState(round=0, global_models=gm, ensemble=TeacherBank(4, 2))
    want = dist.ensemble_predict(gm, {"x": torch.from_numpy(x_te[:64])}, task.logits_fn)
    got = make_runner("fedsdd", task, device="cpu", **small()).ensemble_eval_fn(empty)
    assert torch.equal(got({"x": torch.from_numpy(x_te[:64])}), want)
    assert pred.shape == y_te[:500].shape
