"""Head fusion never materialises the student's (B, V) logit row.

The reference proves this on the jaxpr of its head-fused loss
(``tests/test_head_fusion.py::test_head_fused_never_materializes_student_row``,
which no longer runs on the installed JAX).  The port proves it with the
counterpart of that walk, ``repro_torch.analysis.live_intermediate_shapes``
over the ``torch.fx`` program of the forward and the backward of
``flash_kd_head_loss`` on the CPU path (the plain version of kernels 9 and
10), traced on fake tensors with dead code eliminated, at B = 4, D = 8,
V = 512 and a tile of 64.  Views of the inputs (a slice of the teacher row,
the head's transpose) are not new memory and are not counted.  No (B, V)
tensor may appear; the (B, tile) blocks must; and the dense composition,
which forms ``h @ W`` first, shows the (B, V) row, so the walk sees what it
is meant to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import live_intermediate_shapes, trace_program  # noqa: E402
from repro_torch.kernels.kd_loss import ops  # noqa: E402

B, D, V, TILE, TAU = 4, 8, 512, 64, 4.0


def _grads(loss_fn):
    """``(h, leaf, b, z, lse) -> (loss, *grads)`` over the leaves that are
    not None: the program whose live intermediates the tests read."""
    def fn(h, leaf, b, z, lse):
        leaves = [x.detach().requires_grad_(True) if x is not None else None
                  for x in (h, leaf, b)]
        loss = loss_fn(*leaves, z, lse)
        return (loss, *torch.autograd.grad(loss, [x for x in leaves if x is not None]))
    return fn


def _inputs(bias: bool, tied: bool):
    r = np.random.default_rng(0)
    h = torch.from_numpy(r.normal(0, 1, (B, D)).astype(np.float32))
    if tied:
        leaf = torch.from_numpy(r.normal(0, 0.5, (V, D)).astype(np.float32))
    else:
        leaf = torch.from_numpy(r.normal(0, 0.5, (D, V)).astype(np.float32))
    b = torch.from_numpy(r.normal(0, 0.5, (V,)).astype(np.float32)) if bias else None
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    return h, leaf, b, z, ops.teacher_cache_lse(z, TAU)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_head_fused_never_materializes_student_row(bias, tied, lse):
    h, leaf, b, z, teacher_lse = _inputs(bias, tied)
    fn = _grads(lambda h, leaf, b, z, t: ops.flash_kd_head_loss(
        h, leaf.T if tied else leaf, b, z, TAU, TILE, teacher_lse=t if lse else None))
    shapes = live_intermediate_shapes(trace_program(fn, h, leaf, b, z, teacher_lse))
    assert (B, V) not in shapes
    assert (B, TILE) in shapes
    grads = fn(h, leaf, b, z, teacher_lse)[1:]
    assert grads[0].shape == (B, D) and grads[1].shape == leaf.shape
    assert (b is None) or grads[2].shape == (V,)


def test_dense_composition_materializes_student_row():
    h, leaf, b, z, teacher_lse = _inputs(True, False)
    fn = _grads(lambda h, leaf, b, z, t: ops.flash_kd_loss(h @ leaf + b, z, TAU, TILE,
                                                           teacher_lse=t))
    assert (B, V) in live_intermediate_shapes(trace_program(fn, h, leaf, b, z, teacher_lse))
