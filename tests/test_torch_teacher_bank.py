"""Port vs reference: ``TeacherBank``'s two read accessors.

``members()`` hands out gathered copies, as the reference's does
(``tests/test_temporal.py::test_members_survive_later_push``): a later
``push`` must not change a member already handed out.  ``member_views()``
is the KD pipeline's no-copy read of the same members, valid until the
next ``push``; before it, it agrees with ``members()`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distill import TeacherBank as JaxTeacherBank  # noqa: E402
from repro_torch.distill import TeacherBank  # noqa: E402


def model(v):
    return {"w": torch.full((2,), float(v))}


def test_members_survive_later_push():
    """The reference's test, on the port: K=1, R=1; hold a member across
    the push that overwrites its slot."""
    te = TeacherBank(K=1, R=1)
    te.push(1, [model(1)])
    held = te.members()[0]
    te.push(2, [model(2)])
    assert float(held["w"][0]) == 1.0


def test_members_survive_later_push_like_the_reference():
    jte, te = JaxTeacherBank(K=1, R=1), TeacherBank(K=1, R=1)
    jte.push(1, [{"w": jnp.full((2,), 1.0)}])
    te.push(1, [model(1)])
    jheld, held = jte.members()[0], te.members()[0]
    jte.push(2, [{"w": jnp.full((2,), 2.0)}])
    te.push(2, [model(2)])
    np.testing.assert_array_equal(held["w"].numpy(), np.asarray(jheld["w"]))


@pytest.mark.parametrize("K,R,stacked", [(1, 1, False), (3, 2, False), (2, 3, True)])
def test_member_views_agree_with_members_before_a_push(K, R, stacked):
    rng = np.random.default_rng(K + R)
    te = TeacherBank(K=K, R=R)
    for t in range(1, R + 2):
        models = [{"w": torch.from_numpy(rng.normal(0, 1, (3, 4)).astype(np.float32)),
                   "b": {"v": torch.from_numpy(rng.normal(0, 1, (4,)).astype(np.float32))}}
                  for _ in range(K)]
        if stacked:
            te.push(t, {"w": torch.stack([m["w"] for m in models]),
                        "b": {"v": torch.stack([m["b"]["v"] for m in models])}})
        else:
            te.push(t, models)
        copies, views = te.members(), te.member_views()
        assert len(copies) == len(views) == te.num_members
        for c, v in zip(copies, views):
            torch.testing.assert_close(c["w"], v["w"], rtol=0, atol=0)
            torch.testing.assert_close(c["b"]["v"], v["b"]["v"], rtol=0, atol=0)


def test_member_views_are_views_and_members_are_copies():
    """The views share the ring's storage (no copy for a model-zoo ring);
    the copies do not, so only the views see the next push."""
    te = TeacherBank(K=1, R=1)
    te.push(1, [model(1)])
    (view,), (copy,) = te.member_views(), te.members()
    assert view["w"].untyped_storage().data_ptr() == te._bank["w"].untyped_storage().data_ptr()
    assert copy["w"].untyped_storage().data_ptr() != te._bank["w"].untyped_storage().data_ptr()
    te.push(2, [model(2)])
    assert float(view["w"][0]) == 2.0 and float(copy["w"][0]) == 1.0


def test_empty_bank_reads_nothing():
    te = TeacherBank(K=2, R=2)
    assert te.members() == [] and te.member_views() == []
