"""Port vs reference: the functional optimizers and Eq. 2 on random trees.

The same numpy trees (params and five steps of gradients) go through
``repro.optim`` and ``repro_torch.optim``; f32 on both sides, atol 1e-6.
Plus the alias trap: every client of a group starts from the same global
tensors, so one client's local training must leave them untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.aggregation import fedavg_aggregate as jax_fedavg  # noqa: E402
from repro.core.aggregation import fedavg_aggregate_stacked as jax_fedavg_stacked  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.utils import pytree as jpytree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.aggregation import fedavg_aggregate, fedavg_aggregate_stacked  # noqa: E402
from repro_torch.core.fedsdd import FedState, make_runner  # noqa: E402
from repro_torch.core.tasks import classification_task  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402
from repro_torch.utils.pytree import tree_map, tree_stack  # noqa: E402

ATOL = 1e-6


def _tree(rng, scale=1.0):
    return {"conv": rng.normal(0, scale, (3, 3, 4, 8)).astype(np.float32),
            "n": {"scale": rng.normal(0, scale, (8,)).astype(np.float32),
                  "bias": rng.normal(0, scale, (8,)).astype(np.float32)},
            "head": {"w": rng.normal(0, scale, (8, 10)).astype(np.float32)}}


def _t(tree):
    return interop.params_from_numpy(tree, device="cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, atol=ATOL):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol),
                 interop.params_to_numpy(port), jax.tree.map(np.asarray, ref))


def _run(make_opt, jmake_opt, steps=5, seed=0, setup=None):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(steps)]
    o, jo = make_opt(), jmake_opt()
    p, jp = _t(p0), _j(p0)
    s, js = o.init(p), jo.init(jp)
    if setup is not None:
        s, js = setup(s, js, rng)
    for g in grads:
        u, s = o.update(_t(g), s, p)
        p = opt.apply_updates(p, u)
        ju, js = jo.update(_j(g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        _close(p, jp)
    return (p, s), (jp, js), p0


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 5e-4), (0.0, 1e-3)])
def test_sgd_matches_reference(momentum, wd):
    _run(lambda: opt.sgd(0.05, momentum=momentum, weight_decay=wd),
         lambda: jopt.sgd(0.05, momentum=momentum, weight_decay=wd))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_fedprox_matches_reference(momentum):
    def anchor(s, js, rng):
        a = _tree(rng)
        s["anchor"], js["anchor"] = _t(a), _j(a)
        return s, js

    _run(lambda: opt.with_fedprox(opt.sgd(0.05, momentum=momentum), 0.01),
         lambda: jopt.with_fedprox(jopt.sgd(0.05, momentum=momentum), 0.01), setup=anchor)


def test_scaffold_and_new_control_match_reference():
    def controls(s, js, rng):
        cl, cg = _tree(rng, 0.1), _tree(rng, 0.1)
        return (s._replace(c_local=_t(cl), c_global=_t(cg)),
                js._replace(c_local=_j(cl), c_global=_j(cg)))

    (p, s), (jp, js), p0 = _run(lambda: opt.with_scaffold(opt.sgd(0.05), 0.05),
                                lambda: jopt.with_scaffold(jopt.sgd(0.05), 0.05),
                                setup=controls)
    assert s.steps == int(js.steps) == 5
    _close(opt.scaffold_new_control(s, _t(p0), p, 0.05),
           jopt.scaffold_new_control(js, _j(p0), jp, 0.05))


@pytest.mark.parametrize("sizes", [[10, 30, 60], [1, 1], [123, 7, 45, 300, 2]])
def test_fedavg_aggregate_matches_reference(sizes):
    rng = np.random.default_rng(len(sizes))
    models = [_tree(rng) for _ in sizes]
    _close(fedavg_aggregate([_t(m) for m in models], sizes),
           jax_fedavg([_j(m) for m in models], sizes))
    _close(fedavg_aggregate_stacked(tree_stack([_t(m) for m in models]), sizes),
           jax_fedavg_stacked(jax.tree.map(lambda *xs: jnp.stack(xs), *map(_j, models)), sizes))


def test_tree_ops_match_reference():
    rng = np.random.default_rng(11)
    a, b, c = _tree(rng), _tree(rng), _tree(rng)
    _close(pytree.tree_scale(_t(a), -0.05), jpytree.tree_scale(_j(a), -0.05))
    _close(pytree.tree_sub(_t(a), _t(b)), jpytree.tree_sub(_j(a), _j(b)))
    _close(pytree.tree_zeros_like(_t(a)), jpytree.tree_zeros_like(_j(a)))
    w = [0.2, 0.5, 0.3]
    _close(pytree.tree_weighted_sum([_t(a), _t(b), _t(c)], w),
           jpytree.tree_weighted_sum([_j(a), _j(b), _j(c)], w))
    _close(pytree.tree_weighted_mean([_t(a), _t(b), _t(c)], [3, 1, 6]),
           jpytree.tree_weighted_mean([_j(a), _j(b), _j(c)], [3, 1, 6]))
    stacked = pytree.tree_stack([_t(a), _t(b)])
    _close(stacked, jpytree.tree_stack([_j(a), _j(b)]))
    for got, want in zip(pytree.tree_unstack(stacked), (a, b)):
        _close(got, want, atol=0)
    assert pytree.tree_leaves(pytree.tree_unflatten(a, pytree.tree_leaves(_t(a))))[0].shape \
        == (3, 3, 4, 8)


@pytest.mark.parametrize("local_algo", ["fedavg", "fedprox", "scaffold"])
def test_local_training_leaves_the_group_model_untouched(local_algo):
    """The alias trap: a client's steps are out of place, so the group's
    global tensors (shared by every client of the group) keep their values
    and their storage."""
    task = classification_task(model="cnn", num_clients=4, alpha=0.5, num_train=200,
                               num_server=256, device="cpu")
    r = make_runner("fedavg", task, device="cpu", num_clients=4, local_algo=local_algo,
                    client_batch=16, local_epochs=1, client_lr=0.1, client_momentum=0.9)
    state = r.init_state()
    g = state.global_models[0]
    before = tree_map(lambda x: x.clone(), g)
    rows = np.arange(30).reshape(3, 10)
    trained = r._local_train_scheduled(g, 0, state, rows)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), g, before)
    moved = tree_map(lambda a, b: float((a - b).abs().max()), trained, before)
    assert max(moved.values()) > 0


def test_teacher_bank_push_copies():
    """The bank holds copies: writing into a pushed model afterwards (as an
    in-place KD update would) leaves the teacher as it was pushed."""
    bank = TeacherBank(2, 1)
    models = [{"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)}]
    bank.push(1, models)
    models[0]["w"].add_(5.0)
    torch.testing.assert_close(bank.members()[0]["w"], torch.ones(3))
    state = FedState(round=0, global_models=models, ensemble=bank)
    assert state.ensemble.num_members == 2
