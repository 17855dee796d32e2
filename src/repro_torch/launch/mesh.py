"""Meshes over the ranks of a ``torch.distributed`` process group, and the
port's collectives (port of ``repro/launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module never
initialises a process group, so the tests and a plain single-card run see a
one-rank mesh while a run under ``torchrun`` sees its ranks.

JAX's ``shard_map`` is single-controller SPMD; ``torch.distributed`` is one
process a rank.  Every rank runs the whole runner from the same seed, so
each has the same host state; only the rows the reference's ``shard_map``
splits are split (the vectorized engine's client axis and the KD
pipeline's teacher-member axis), and they meet again through the two
collectives below:

``all_gather_tree``
    every rank's rows of a stacked tree, concatenated in rank order on
    every rank (the reference's ``out_specs=P('clients')``): one
    all-gather a dtype, over the leaves flattened side by side.
``all_reduce_sum``
    the elementwise sum over the ranks, in place (the reference's
    ``psum``).

On a mesh with no process group (one rank) both are identities and issue
nothing.  With a group, the backend follows the device: NCCL for CUDA
tensors, gloo for the CPU's.  Each collective issued is counted in the
open ``analysis.collective_stats`` scopes.

Streams: ProcessGroupNCCL runs every collective of a group on that group's
one internal stream, after an event wait on the caller's current stream,
and the caller's stream then waits for it.  The port issues all of its
collectives on one group (the default), from one host thread, in the host
program's order, which is the same on every rank because every rank runs
the same program.  So the KD lane's teacher all-reduce and the main
stream's all-gathers are serialised in one order on every rank, and
cannot interleave differently across ranks.
"""
from __future__ import annotations

import math
import os
from typing import Any

import torch

from repro_torch.analysis.passes import record_collective
from repro_torch.sharding.specs import CLIENT_AXIS
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

CHIPS_PER_POD = 256            # 16 × 16 TPU v5e pod (the reference's production mesh)
PODS = 2


class Mesh:
    """Named axes over the ranks of a process group, row-major in rank order.

    ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does.  ``group`` is the process group whose ranks the
    mesh spans, or ``None``: a one-rank mesh with no group (its collectives
    are identities), or a shape-only mesh (``make_production_mesh``).
    ``device_type`` is ``"cuda"`` for an NCCL group, ``"cpu"`` for gloo.
    """

    def __init__(self, shape: dict, group=None, device_type: str | None = None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.group = group
        self.device_type = device_type

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 with no group)."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` over the same ranks and
        axis names (what DTensor's placements live on)."""
        if self.group is None:
            raise ValueError("a mesh with no process group has no DeviceMesh: "
                             "initialise torch.distributed first")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(self.device_type, tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type or 'no process group'})"


def _world():
    """(world size, group, device type) of the default process group, or
    (1, None, None) when none is initialised."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1, None, None
    backend = dist.get_backend()
    return dist.get_world_size(), dist.group.WORLD, ("cuda" if backend == "nccl" else "cpu")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``, as a
    shape-only stand-in: ``.shape`` maps each axis to its size, which is
    all ``sharding.specs`` reads.  ``launch/dryrun.py`` pairs it with a
    ``DeviceMesh`` of the same shape over a fake process group
    (``fake_world``) to partition the full-size programs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over whatever ranks exist (the CPU
    tests: one): each axis cut to what the ranks allow, as the reference
    cuts it to the devices."""
    n, group, device_type = _world()
    data = min(data, n)
    model = min(model, n // data)
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not span the {n} ranks of the "
                         f"process group")
    return Mesh({"data": data, "model": model}, group, device_type)


def make_client_mesh(num_devices: int | None = None) -> Mesh:
    """1-D ``('clients',)`` mesh for the vectorized client engine AND the
    KD pipeline's sharded teacher precompute, over the ranks of the default
    process group; with no group (the CPU tests, a plain single-card run) a
    one-rank mesh.

    The engine stacks sampled clients along a leading axis and trains each
    rank's block of rows; the KD pipeline splits the teacher members over
    the same mesh.  With one rank both degenerate to plain vmap unless
    ``REPRO_FORCE_SHARD_MAP=1`` or ``client_sharding="shard_map"``."""
    n, group, device_type = _world()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"a client mesh spans every rank of the process group: "
                         f"num_devices={num_devices}, {n} rank(s)")
    return Mesh({CLIENT_AXIS: n}, group, device_type)


def mesh_size(mesh) -> int:
    """Total rank count of a mesh (the shard count the engine and the KD
    pipeline pad their leading axes to)."""
    return math.prod(mesh.shape.values())


def use_shard_map(mesh, policy: str) -> bool:
    """THE auto|vmap|shard_map decision, shared by the client engine and
    the KD pipeline's teacher precompute so the two sharded paths can
    never drift: ``vmap`` never shards, ``shard_map`` (or the
    ``REPRO_FORCE_SHARD_MAP=1`` escape hatch) always does when a mesh
    exists, ``auto`` shards exactly when the mesh spans >1 rank."""
    if policy == "vmap" or mesh is None:
        return False
    if policy == "shard_map" or os.environ.get("REPRO_FORCE_SHARD_MAP") == "1":
        return True
    return mesh_size(mesh) > 1


# ------------------------------------------------------------ collectives
def all_gather_tree(tree: Any, mesh: Mesh) -> Any:
    """Every rank's rows of a stacked tree (each tensor leaf ``(n_local,
    ...)``), concatenated in rank order: leaves ``(size · n_local, ...)``
    on every rank.  The leaves of one dtype travel as one ``(n_local, D)``
    buffer, side by side, so a tree costs one all-gather a dtype.  0-d
    tensors and host values (SCAFFOLD's step count) are the same on every
    rank and pass through."""
    if mesh.group is None:
        return tree
    import torch.distributed as dist
    n = mesh.size
    leaves = tree_leaves(tree)
    out = list(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.ndim >= 1:
            by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        rows = leaves[idx[0]].shape[0]
        flat = torch.cat([leaves[i].reshape(rows, -1) for i in idx], dim=1)
        full = torch.empty((n * rows, flat.shape[1]), dtype=dtype, device=flat.device)
        dist.all_gather_into_tensor(full, flat, group=mesh.group)
        record_collective("all-gather", full.numel() * full.element_size())
        col = 0
        for i in idx:
            x = leaves[i]
            width = x[0].numel()
            out[i] = full[:, col:col + width].reshape((n * rows,) + tuple(x.shape[1:]))
            col += width
    return tree_unflatten(tree, out)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed elementwise over the mesh's ranks, in place (and
    returned)."""
    if mesh.group is None:
        return x
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    record_collective("all-reduce", x.numel() * x.element_size())
    return x
