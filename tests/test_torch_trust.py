"""Trust-weighted teachers and the ring's robustness hooks against the
reference (``repro/distill/pipeline.py`` ``trust_weights`` and the
weighted cache; ``repro/distill/teacher_bank.py``).

  (a) ``KDPipeline.trust_weights`` equals the reference's at atol 1e-6 for
      M = 8 and M = 3 teachers (the consensus a median over an even count
      too), with a degraded mask; a poisoned teacher gets exactly 0 in both,
      and the trust-weighted distillation stays near the attack-free one
      while the uniform ensemble does not;
  (b) the weighted cache (dense: kernel 2's plain version over the M = 1
      stack of Σ w_m z_m; flash: the weighted mean logits and their lse)
      against the reference's weighted programs; without weights the cache
      is bit-identical to the uniform build, and uniform weights agree with
      it at 1e-5;
  (c) the ring: ``degraded_mask_stacked`` aligned with the members as the
      reference's; ``spill_dir`` writes an evicted round in the
      reference's layout; ``export_state`` / ``import_state`` round trip;
  (d) 2 FedSDD rounds with ``teacher_trust`` from the JAX init weights on
      both engines: the recorded weights and the models within 2e-4 of the
      JAX runner; overlapped (``async``) within 2e-4 of ``off``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fedsdd import make_runner as jax_make_runner  # noqa: E402
from repro.core.tasks import classification_task as jax_classification_task  # noqa: E402
from repro.distill.pipeline import KDPipeline as JaxKDPipeline  # noqa: E402
from repro.distill.teacher_bank import TeacherBank as JaxTeacherBank  # noqa: E402
from repro.utils.pytree import tree_stack as jax_tree_stack  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import KDPipeline, TeacherBank  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ATOL = RTOL = 2e-4


def _linear_logits(p, b):
    return b["x"] @ p["w"]


def _teachers(M, poisoned: bool, seed=0, d=8, v=5):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, (d, v)).astype(np.float32)
    good = [{"w": (w_true + rng.normal(0, 0.05, (d, v))).astype(np.float32)}
            for _ in range(M - int(poisoned))]
    if poisoned:
        good.append({"w": -3.0 * w_true})
    batches = [{"x": rng.normal(0, 1, (32, d)).astype(np.float32)} for _ in range(3)]
    return w_true, good, batches


def _port(tree_list):
    return [{k: torch.from_numpy(np.array(v)) for k, v in t.items()} for t in tree_list]


def _jax(tree_list):
    return [jax.tree.map(jnp.asarray, t) for t in tree_list]


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("M", [8, 3])
@pytest.mark.parametrize("degraded", [False, True])
def test_trust_weights_match_reference(M, degraded):
    _, teachers, batches = _teachers(M, poisoned=True, seed=M)
    mask = [k == 1 for k in range(M)] if degraded else None
    pipe = KDPipeline(_linear_logits, steps=1, lr=0.1, temperature=2.0, device="cpu")
    jpipe = JaxKDPipeline(_linear_logits, steps=1, lr=0.1, temperature=2.0)
    w = pipe.trust_weights(_port(teachers), _port(batches), degraded_mask=mask)
    jw = jpipe.trust_weights(jax_tree_stack(_jax(teachers)), _jax(batches), degraded_mask=mask)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    assert float(w[-1]) == 0.0 == float(jw[-1])     # the liar weighs exactly 0
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-6)


def test_trust_weighted_distillation_holds_against_a_poisoned_teacher():
    w_true, teachers, batches = _teachers(4, poisoned=True)
    pipe = KDPipeline(_linear_logits, steps=40, lr=0.3, temperature=2.0, device="cpu")
    pt, pb = _port(teachers), _port(batches)
    w = pipe.trust_weights(pt, pb)
    assert float(w[3]) == 0.0 and all(float(x) > 0.1 for x in w[:3])
    wc = pipe.trust_weights(pt[:3], pb)              # a clean round filters nobody
    assert (wc > 0.1 / 3).all() and float(wc.max() / wc.min()) < 5.0
    wd = pipe.trust_weights(pt, pb, degraded_mask=[False, True, False, False])
    assert float(wd[1]) < float(w[1])
    rng = np.random.default_rng(9)
    student = {"w": torch.from_numpy(rng.normal(0, 1, w_true.shape).astype(np.float32))}
    xs = rng.normal(0, 1, (256, w_true.shape[0])).astype(np.float32)
    labels = np.argmax(xs @ w_true, -1)

    def acc(p):
        return float(np.mean(np.argmax(xs @ p["w"].numpy(), -1) == labels))

    clean, _ = pipe.distill(student, pt[:3], pb)
    trust, info = pipe.distill(student, pt, pb, teacher_weights=w)
    naive, _ = pipe.distill(student, pt, pb)
    assert abs(acc(trust) - acc(clean)) <= 0.05 and acc(trust) >= acc(naive)


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("kd_kernel", ["dense", "flash"])
def test_weighted_cache_matches_reference(kd_kernel):
    _, teachers, batches = _teachers(5, poisoned=False, seed=1)
    kw = dict(steps=1, lr=0.1, temperature=2.0, kd_kernel=kd_kernel,
              cache_dtype="float32" if kd_kernel == "flash" else None)
    pipe = KDPipeline(_linear_logits, device="cpu", **kw)
    jpipe = JaxKDPipeline(_linear_logits, **kw)
    pt, pb = _port(teachers), pipe.batches_for(_port(batches))
    jt, jb = jax_tree_stack(_jax(teachers)), jpipe.batches_for(_jax(batches))
    w = np.asarray([0.5, 0.0, 0.2, 0.2, 0.1], np.float32)
    got = pipe.precompute_cache(pt, pb, weights=torch.from_numpy(w))
    want = jpipe.precompute_cache(jt, jb, weights=w)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # trust off: the uniform build as it is; uniform weights agree with it
    plain = pipe.precompute_cache(pt, pb)
    again = pipe.precompute_cache(pt, pb, weights=None)
    uniform = pipe.precompute_cache(pt, pb, weights=torch.full((5,), 0.2))
    before = (pipe.precompute_teacher_probs(pt, pb) if kd_kernel == "dense"
              else pipe.precompute_mean_logits(pt, pb))
    assert torch.equal(tree_leaves(plain)[0], before)
    for a, b, c in zip(tree_leaves(plain), tree_leaves(again), tree_leaves(uniform)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- (c)
def _m(v):
    return {"w": torch.full((2,), float(v))}


def test_degraded_mask_alignment_matches_reference():
    bank, jbank = TeacherBank(K=2, R=2), JaxTeacherBank(K=2, R=2)
    assert bank.degraded_mask_stacked() is None
    for t, deg in ((1, ()), (2, (1,)), (3, ())):
        bank.push(t, [_m(10 * t), _m(10 * t + 1)], degraded=deg)
        jbank.push(t, [{"w": jnp.full((2,), 10.0 * t)}, {"w": jnp.full((2,), 10.0 * t + 1)}],
                   degraded=deg)
        np.testing.assert_array_equal(bank.degraded_mask_stacked(),
                                      jbank.degraded_mask_stacked())
    np.testing.assert_array_equal(bank.degraded_mask_stacked(), [False, False, False, True])


def test_spill_dir_writes_the_reference_layout(tmp_path):
    from repro.fedckpt.checkpointer import load_pytree as jax_load
    bank = TeacherBank(K=2, R=1, spill_dir=str(tmp_path))
    bank.push(1, [_m(1), _m(2)])
    bank.push(2, [_m(3), _m(4)])         # evicts round 1 to disk
    assert sorted(p.name for p in tmp_path.iterdir()) == ["r00001_g0.npz", "r00001_g1.npz"]
    got = jax_load(str(tmp_path / "r00001_g1.npz"), {"w": jnp.zeros(2)})
    np.testing.assert_array_equal(np.asarray(got["w"]), [2.0, 2.0])


def test_bank_export_import_round_trip():
    bank = TeacherBank(K=2, R=2, dtype="bfloat16")
    for t in (1, 2, 3):
        bank.push(t, [_m(t), _m(t + 0.5)], degraded=(0,) if t == 2 else ())
    ring, meta = bank.export_state()
    assert meta == {"slot_rounds": [3, 2], "cursor": 1, "degraded": {"2": [0]}}
    like = bank.bank_like(_m(0))
    assert like["w"].shape == (2, 2, 2) and like["w"].dtype == torch.bfloat16
    fresh = TeacherBank(K=2, R=2, dtype="bfloat16")
    fresh.import_state(ring, meta)
    assert fresh.rounds_held() == [2, 3] and fresh.degraded_rounds() == {2: (0,)}
    assert torch.equal(fresh.members_stacked()["w"], bank.members_stacked()["w"])


# ------------------------------------------------------------------- (d)
TASK = dict(model="mlp", num_clients=4, num_train=256, num_server=256, seed=0)
RUN = dict(num_clients=4, K=2, R=2, rounds=2, participation=1.0, local_epochs=1,
           distill_steps=2, client_lr=0.05, server_lr=0.05, seed=0, teacher_trust=True)


@pytest.fixture(scope="module")
def trust_runs():
    jtask = jax_classification_task(**TASK)
    jst = jax_make_runner("fedsdd", jtask, **RUN).run()
    init = [interop.params_from_numpy(jax.tree.map(np.asarray, jtask.init_fn(k)), device="cpu")
            for k in jax.random.split(jax.random.PRNGKey(0), 2)]
    return jst, init, classification_task(**TASK, device="cpu")


@pytest.mark.parametrize("execution,overlap", [("sequential", "off"), ("vectorized", "off"),
                                               ("sequential", "async")])
def test_teacher_trust_rounds_match_jax(trust_runs, execution, overlap):
    jst, init, task = trust_runs
    r = make_runner("fedsdd", task, device="cpu", execution=execution, overlap=overlap, **RUN)
    st = FedState(round=0, global_models=[dict(m) for m in init], ensemble=TeacherBank(2, 2))
    st = r.run(2, state=st)
    for rec, jrec in zip(st.history, jst.history):
        assert len(rec["teacher_trust"]) == len(jrec["teacher_trust"])
        np.testing.assert_allclose(rec["teacher_trust"], jrec["teacher_trust"], atol=2e-4)
    assert len(st.history[-1]["teacher_trust"]) == st.ensemble.num_members == 4
    for m, jm in zip(st.global_models, jst.global_models):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL),
                     interop.params_to_numpy(m), jax.tree.map(np.asarray, jm))
