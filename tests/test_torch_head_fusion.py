"""Head fusion never materialises the student's (B, V) logit row.

The reference proves this on the jaxpr of its head-fused loss
(``tests/test_head_fusion.py::test_head_fused_never_materializes_student_row``,
which no longer runs on the installed JAX).  The port proves it on what
PyTorch executes: a ``TorchDispatchMode`` records the shape of every tensor
that an operator writes into new memory, during the forward and the
backward of ``flash_kd_head_loss`` on the CPU path (the plain version of
kernels 9 and 10) at B = 4, D = 8, V = 512 and a tile of 64.  Views of the
inputs (a slice of the teacher row, the head's transpose) are not new
memory and are not recorded.  No (B, V) tensor may appear; the (B, tile)
blocks must; and the dense composition, which forms ``h @ W`` first, shows
the (B, V) row, so the probe sees what it is meant to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.kernels.kd_loss import ops  # noqa: E402

B, D, V, TILE, TAU = 4, 8, 512, 64, 4.0


class NewTensorShapes(TorchDispatchMode):
    """Shapes of the operator outputs that do not share storage with any
    of the operator's tensor inputs."""

    def __init__(self):
        super().__init__()
        self.shapes: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in inputs:
                self.shapes.append(tuple(t.shape))
        return out


def _inputs(bias: bool, tied: bool):
    r = np.random.default_rng(0)
    h = torch.from_numpy(r.normal(0, 1, (B, D)).astype(np.float32)).requires_grad_(True)
    if tied:
        leaf = torch.from_numpy(r.normal(0, 0.5, (V, D)).astype(np.float32)).requires_grad_(True)
    else:
        leaf = torch.from_numpy(r.normal(0, 0.5, (D, V)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(r.normal(0, 0.5, (V,)).astype(np.float32)).requires_grad_(True) \
        if bias else None
    z = torch.from_numpy(r.normal(0, 3, (B, V)).astype(np.float32)).to(torch.bfloat16)
    return h, leaf, b, z, ops.teacher_cache_lse(z, TAU)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("lse", [False, True], ids=["online", "teacher_lse"])
def test_head_fused_never_materializes_student_row(bias, tied, lse):
    h, leaf, b, z, teacher_lse = _inputs(bias, tied)
    with NewTensorShapes() as probe:
        w = leaf.T if tied else leaf
        loss = ops.flash_kd_head_loss(h, w, b, z, TAU, TILE,
                                      teacher_lse=teacher_lse if lse else None)
        loss.backward()
    assert (B, V) not in probe.shapes
    assert (B, TILE) in probe.shapes
    assert h.grad.shape == (B, D) and leaf.grad.shape == leaf.shape
    assert (b is None) or b.grad.shape == (V,)


def test_dense_composition_materializes_student_row():
    h, leaf, b, z, teacher_lse = _inputs(True, False)
    with NewTensorShapes() as probe:
        loss = ops.flash_kd_loss(h @ leaf + b, z, TAU, TILE, teacher_lse=teacher_lse)
        loss.backward()
    assert (B, V) in probe.shapes
