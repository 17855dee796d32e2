"""Multi-pod dry run over a fake process group (port of
``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) combination this runs the
step the reference lowers (train_step / prefill_step / serve_step, or with
``--fedsdd`` the FedSDD round) on DTensors over a fake default process
group: 256 ranks, ``(16, 16)`` over ``("data", "model")`` (pod1), or 512,
``(2, 16, 16)`` with ``"pod"`` (pod2).  The step's inputs are the full-size
specs of ``launch/steps.py``, placed by ``sharding/specs.py``'s policies
(``to_shardings(...).distribute``).  It records what rank 0 computes on
its local shards, after every redistribution:

  * FLOPs of products, convolutions and attention: ``torch.utils.
    flop_counter``'s formulas on the local shapes;
  * HBM bytes: the bytes of the inputs and outputs of every op that is not
    a view (the port's card path is unfused eager ops replayed from
    graphs, so this is its traffic);
  * collective bytes and counts by kind (``analysis.collective_stats``;
    the result-shape convention of the reference's HLO count);
  * peak live bytes (``memory_analysis``: argument, output and temp bytes).

Nothing is allocated and nothing runs on a card: the local shards are
``meta`` tensors, the collectives go to the fake group.  No kernel is
launched: the steps run their plain ops, and the FedSDD round the KD
kernels' plain versions (``kernels/kd_loss/ref.py``), as the reference's
dry run counts its CPU placeholder devices, where ``_use_pallas()`` is
false: each record says ``"counted": "plain ops"``.  The model's blocks that DTensor cannot partition by itself run on
local shards (``sharding/local.py``).

DEPTH.  The port loops over its layers in Python, so the count is of the
full depth, exactly; there is no scan body to extrapolate from.
``shallow_raw`` keeps the counts at one and two superblocks
(``_shallow_cfgs``), the two points of the reference's estimator, with
which ``cost(full) == cost(d1) + (n_super - 1)·(cost(d2) - cost(d1))``
(``tests/test_torch_dryrun.py``).

THE FEDSDD ROUND (``--fedsdd``).  One rank's program, as the port's
runtime runs a round (``launch/mesh.py``): the rank holds its groups
(split over ``"pod"``) and its clients (split over ``"data"``) as local
rows, each client's model a DTensor over the ``"model"`` axis.  Eq. 2 sums
a group's clients over ``"data"``; the teacher mean over the groups is
``all_reduce_sum`` over ``"pod"`` (the reference's ``psum``), the only
traffic between groups: its bytes, the server rows' logits on one rank,
do not grow with the client count.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys, so ``benchmarks/roofline.py`` renders them:

  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --fedsdd
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch

from repro_torch.analysis.passes import collective_stats, record_collective
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh, all_reduce_sum, make_production_mesh
from repro_torch.models.layers import _FREQS
from repro_torch.models.model_zoo import build_model
from repro_torch.sharding.specs import batch_pspec, cache_pspec, param_pspec, to_shardings
from repro_torch.utils.hlo import roofline
from repro_torch.utils.pytree import tree_leaves, tree_map

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
COUNTED = "plain ops"

# _c10d_functional ops (DTensor's redistributions) by the reference's kinds
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
}
# ops that move no HBM bytes: metadata, allocations without a write
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "_local_scalar_dense", "device", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "wait_tensor"}

# in-place writes of rows into their first argument (a decode's cache row)
_ROW_WRITES = {"index_copy_", "index_put_", "scatter_", "scatter_add_", "index_add_"}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2" if multi_pod else "pod1"


# ---------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(shape: tuple, axes: tuple):
    """A fake default process group with one rank for each device of a
    mesh of ``shape`` over ``axes``, and that mesh: yields (``Mesh`` over
    the group, its ``DeviceMesh``).  This process is rank 0; collectives
    return at once.  Raises if a default group is live already (it never
    reuses one); destroys its own on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is live already "
                           f"({dist.get_backend()}, {dist.get_world_size()} ranks)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        _register_strategies()
        dm = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
        yield Mesh(dict(zip(axes, shape)), dist.group.WORLD, "cpu"), dm
    finally:
        dist.destroy_process_group()


_REGISTERED: list = []


def _register_strategies() -> None:
    """DTensor's sharding for ops it has none for: ``log_sigmoid``'s
    forward and backward (mLSTM's forget gate) are elementwise, so any
    placement of the input is the output's."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_forward.default)
    def _fwd(x):
        return ([([Shard(d), Shard(d)], [Shard(d)]) for d in range(x.ndim)]
                + [([Replicate(), Replicate()], [Replicate()])])

    @register_sharding(aten.log_sigmoid_backward.default)
    def _bwd(g, x, buf):
        return ([([Shard(d)], [Shard(d)] * 3) for d in range(x.ndim)]
                + [([Replicate()], [Replicate()] * 3)])

    _REGISTERED.append(True)


# ---------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class RankCount:
    """What one rank computes, counted from the ops it dispatches on its
    local tensors (a dispatch mode below DTensor: an op on DTensors is
    passed to DTensor, which runs it on the local shards and comes back
    here).  DTensor's own shape propagation, which runs ops on global fake
    tensors, is not counted."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._in_propagation = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._storages:
            return
        n = s.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def on_op(self, func, args, kwargs, out) -> None:
        if self._in_propagation:
            return
        from torch.utils.flop_counter import flop_registry
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in _FUNCOL_KINDS:
            record_collective(_FUNCOL_KINDS[name], sum(_nbytes(t) for t in outs))
            return
        if ns in ("_c10d_functional", "c10d", "prim") or name in _FREE:
            return
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return      # a view: no bytes move
        if name in _ROW_WRITES:     # reads its sources, writes their rows
            self.bytes += 2 * sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
            return
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(_nbytes(t) for t in outs)

    @contextlib.contextmanager
    def counting(self):
        """The scope whose local ops are counted (with DTensor's shape
        propagation excluded)."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode
        count = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                count.on_op(func, args, kwargs, out)
                return out

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)

        def propagate(prop, *a, **k):
            count._in_propagation += 1
            try:
                return orig(prop, *a, **k)
            finally:
                count._in_propagation -= 1

        setattr(ShardingPropagator, name, propagate)
        try:
            with _Mode():
                yield self
        finally:
            setattr(ShardingPropagator, name, orig)


def _count(fn, args) -> dict:
    """Run ``fn(*args)`` (DTensors of ``meta`` tensors) and count rank 0's
    work: the reference's ``_compile_and_analyze`` keys, where "lower_s" is
    the time to place the inputs (``args`` is a thunk) and "compile_s" the
    counted run's."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    args = args()
    t_place = time.time() - t0
    count = RankCount()
    local = [t.to_local() if hasattr(t, "to_local") else t for t in _tensors(args)]
    for t in local:
        count.track(t)
    arg_bytes = sum(_nbytes(t) for t in local)
    # every count starts with no RoPE table cached (each copies its own, a
    # few hundred bytes), so that counts do not depend on the ones before
    cached = dict(_FREQS)
    _FREQS.clear()
    t0 = time.time()
    with collective_stats() as coll, count.counting(), implicit_replication():
        out = fn(*args)
        out_local = [t.to_local() if hasattr(t, "to_local") else t for t in _tensors(out)]
    t_run = time.time() - t0
    _FREQS.clear()
    _FREQS.update(cached)
    out_bytes = sum(_nbytes(t) for t in out_local)
    del out, out_local, args, local
    return {
        **getattr(fn, "record", {}),    # what the program records of itself
        "lower_s": round(t_place, 2),
        "compile_s": round(t_run, 2),
        "flops": float(count.flops),
        "bytes": float(count.bytes),
        "coll_bytes": float(coll.total_bytes),
        "coll_by_kind": dict(coll.bytes_by_kind),
        "coll_counts": dict(coll.count_by_kind),
        "mem": {"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": max(0, count.peak - arg_bytes - out_bytes),
                "peak_size_in_bytes": count.peak},
    }


# ---------------------------------------------------------------------
def _placed(spec, sharding):
    """A DTensor of ``meta`` shards of ``spec`` placed by ``sharding``."""
    return sharding.distribute(_meta(spec.shape, spec.dtype))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_jitted(cfg, shape, mesh, *, multi_pod: bool, fedsdd: bool,
                 period_mult: int = 1, sgd_lr: float = 0.1,
                 spec_overrides=None, pspec_overrides=None,
                 cache_seq_axis=None, remat: bool | str = True):
    """(step function, a thunk of its DTensor arguments) for one step
    variant on ``mesh`` (a ``(Mesh, DeviceMesh)`` pair of ``fake_world``);
    the arguments' shards are ``meta`` tensors.  ``period_mult`` must be 1: the
    port's models stack one period of layers (``_shallow_cfgs``)."""
    if period_mult != 1:
        raise ValueError("the port's models stack one period of layers: period_mult=1")
    smesh, dm = mesh
    model = build_model(cfg)
    batch_axis = ("pod", "data") if (multi_pod and not fedsdd) else "data"
    p_specs = steps_lib.param_specs(model)
    ppsec = param_pspec(p_specs, cfg, smesh, fsdp_axis="data")
    if pspec_overrides:
        ppsec = pspec_overrides(ppsec)
    if fedsdd:
        return _fedsdd_program(model, cfg, shape, smesh, dm, sgd_lr=sgd_lr,
                               spec_overrides=spec_overrides or {})
    p_shard = to_shardings(ppsec, dm)

    def params():
        return tree_map(_placed, p_specs, p_shard)

    if shape.kind in ("train", "prefill"):
        b_specs = steps_lib.batch_specs(cfg, shape)
        b_shard = to_shardings(batch_pspec(b_specs, shape, smesh, batch_axis=batch_axis), dm)
        fn = (steps_lib.make_train_step(model, lr=sgd_lr, remat=remat) if shape.kind == "train"
              else steps_lib.make_prefill_step(model))
        return fn, lambda: (params(), tree_map(_placed, b_specs, b_shard))
    c_specs = steps_lib.cache_specs(model, shape)
    seq_on_data = shape.global_batch < smesh.shape["data"]
    c_shard = to_shardings(cache_pspec(c_specs, cfg, smesh, batch_axis=batch_axis,
                                       seq_on_data=seq_on_data, seq_axis=cache_seq_axis), dm)
    t_spec = steps_lib._sds((shape.global_batch, 1), torch.int32)
    t_shard = to_shardings(batch_pspec({"t": t_spec}, shape, smesh, batch_axis=batch_axis),
                           dm)["t"]
    pos = shape.seq_len - 1              # the last slot: the whole cache is live
    return steps_lib.make_serve_step(model), lambda: (
        params(), _placed(t_spec, t_shard), tree_map(_placed, c_specs, c_shard), pos)


def _fedsdd_program(model, cfg, shape, smesh, dm, *, sgd_lr: float,
                    spec_overrides: dict, temperature: float = 4.0):
    """The FedSDD round as rank 0's program (see the module docstring):
    local training of the rank's clients of each of its groups, Eq. 2 over
    ``"data"``, the teacher logits' sum over ``"pod"``, and the KD step on
    the main model, which the rank holds as it holds group 0."""
    from repro_torch.kernels.kd_loss import ref as kd_ref
    from repro_torch.optim.optimizers import value_and_grad
    K = smesh.shape.get("pod", 2)
    specs = steps_lib.fedsdd_round_specs(cfg, shape, K=K, **spec_overrides)
    n_cl = specs["client_weights"].shape[1]
    k_local = K // smesh.shape["pod"] if "pod" in smesh.shape else K
    data = smesh.shape["data"]
    n_local = n_cl // data if n_cl % data == 0 else n_cl
    # a client's model over "model" only: "data" holds the clients
    p_specs = steps_lib.param_specs(model)
    tp = to_shardings(param_pspec(p_specs, cfg, Mesh({"model": smesh.shape["model"]})),
                      dm["model"])
    # the rank's rows of the server batch (split over "data" where they
    # divide it) and of its clients' batches: the same on every "model" rank
    sb_specs = specs["server_batch"]
    s_spec = batch_pspec(sb_specs, shape, smesh, batch_axis="data")
    server_shapes = {k: (v.shape[0] // (data if s_spec[k][0] == "data" else 1),
                         *v.shape[1:]) for k, v in sb_specs.items()}
    cb = {k: steps_lib._sds(v.shape[2:], v.dtype) for k, v in specs["client_batches"].items()}
    groups = Mesh({"pod": smesh.shape["pod"]}, dm.get_group("pod"), "cpu") \
        if "pod" in smesh.shape else None
    clients = Mesh({"data": data}, dm.get_group("data"), "cpu") if n_local < n_cl else None
    grad_fn = value_and_grad(lambda p, b: model.loss(p, b, remat=True)[0])
    kd_grad = value_and_grad(lambda p, b, t: kd_ref.kd_loss_ref(
        model.logits(p, b)[0].reshape(-1, t.shape[-1]), t, temperature))

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    def round_step(stacked, batches, weights, server):
        new = []
        for g in range(k_local):
            w = weights[g] / weights[g].sum()
            agg = None
            for n in range(n_local):
                _, grads = grad_fn(stacked[g], batches[g][n])
                p = tree_map(lambda x, d: x - sgd_lr * d.to(x.dtype), stacked[g], grads)
                term = tree_map(lambda x: (w[n] * x.float()), p)
                agg = term if agg is None else tree_map(torch.add, agg, term)
            if clients is not None:         # Eq. 2 over the group's clients
                for x in tree_leaves(agg):
                    all_reduce_sum(local(x), clients)
            new.append(tree_map(lambda a, x: a.to(x.dtype), agg, stacked[g]))
        with torch.no_grad():
            t_sum = sum(model.logits(p, server)[0] for p in new)
            if groups is not None:          # the teacher mean over the groups
                with collective_stats() as teacher:
                    all_reduce_sum(local(t_sum), groups)
                round_step.record["teacher_all_reduce_bytes"] = teacher.total_bytes
            probs = kd_ref.ensemble_softmax_ref((t_sum / K).reshape(1, -1, t_sum.shape[-1]),
                                                temperature)
        _, g = kd_grad(new[0], server, probs)
        new[0] = tree_map(lambda x, d: x - sgd_lr * d.to(x.dtype), new[0], g)
        return new

    def args():
        stacked = [tree_map(_placed, p_specs, tp) for _ in range(k_local)]
        batches = [[{k: _meta(v.shape, v.dtype) for k, v in cb.items()}
                    for _ in range(n_local)] for _ in range(k_local)]
        weights = _meta((k_local, n_cl), torch.float32)
        server = {k: _meta(server_shapes[k], v.dtype) for k, v in sb_specs.items()}
        return stacked, batches, weights, server

    round_step.record = {"teacher_all_reduce_bytes": 0}
    return round_step, args


def _shallow_cfgs(cfg):
    """The estimator's two depths: one and two superblocks after the
    prefix (the reference's q+2p and q+4p, which its scans count as one and
    two bodies; the port counts every layer), and ``n_super``."""
    m = build_model(cfg)
    q, p = m.prefix_period
    return (dataclasses.replace(cfg, num_layers=q + p),
            dataclasses.replace(cfg, num_layers=q + 2 * p),
            m.n_super)


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              fedsdd: bool = False, sgd_lr: float = 0.1,
              extra_tag: str = "", spec_overrides=None,
              pspec_overrides=None, skip_full: bool = False,
              cache_seq_axis=None, remat: bool | str = True,
              cfg_override=None, proof_only: bool = False,
              mesh_shape: dict | None = None, shape_override=None):
    """Count one combination on a fake world; returns the result record.
    ``mesh_shape`` ({axis: size}) and ``shape_override`` (an
    ``InputShape``) replace the production mesh and the named shape (the
    tests' small worlds)."""
    shape = shape_override or get_shape(shape_name)
    cfg0 = get_config(arch)
    ok, reason = steps_lib.supported(cfg0, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
        "fedsdd": fedsdd, "supported": bool(ok), "skip_reason": reason,
    }
    if not ok:
        return rec
    cfg = steps_lib.config_for_shape(cfg0, shape)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    shape_of = mesh_shape or make_production_mesh(multi_pod=multi_pod).shape
    axes, dims = tuple(shape_of), tuple(shape_of.values())
    chips = math.prod(dims)
    kw = dict(multi_pod=multi_pod, fedsdd=fedsdd, sgd_lr=sgd_lr,
              spec_overrides=spec_overrides, pspec_overrides=pspec_overrides,
              cache_seq_axis=cache_seq_axis, remat=remat)

    with fake_world(dims, axes) as mesh:
        full = None if skip_full else _count(*build_jitted(cfg, shape, mesh, **kw))
        if proof_only:
            # the multi-pod proof: the full program's counts only
            rec.update({
                "proof_only": True, "counted": COUNTED,
                "chips": chips,
                "step_kind": "fedsdd_round" if fedsdd else shape.kind,
                "compile_s": full["compile_s"],
                "lower_s": full["lower_s"],
                "scan_raw_flops_per_chip": full["flops"],
                "collective_bytes_scan_body": full["coll_bytes"],
                "collectives_scan_body": full["coll_by_kind"],
                "memory_analysis": _mem_dict(full["mem"]),
            })
            if fedsdd:
                rec["teacher_all_reduce_bytes"] = full["teacher_all_reduce_bytes"]
            if extra_tag:
                rec["tag"] = extra_tag
            return rec
        c1, c2, n_super = _shallow_cfgs(cfg)
        r1 = _count(*build_jitted(c1, shape, mesh, **kw))
        r2 = _count(*build_jitted(c2, shape, mesh, **kw))

    def total(key):
        if full is not None:
            return full[key]
        return r1[key] + (r2[key] - r1[key]) * (n_super - 1)

    flops, hbm_bytes, coll_bytes = total("flops"), total("bytes"), total("coll_bytes")
    if full is not None:
        coll_kinds = dict(full["coll_by_kind"])
    else:
        coll_kinds = {k: r1["coll_by_kind"].get(k, 0.0)
                      + (r2["coll_by_kind"].get(k, 0.0) - r1["coll_by_kind"].get(k, 0.0))
                      * (n_super - 1)
                      for k in set(r1["coll_by_kind"]) | set(r2["coll_by_kind"])}
    dtype = str(cfg.cdtype).removeprefix("torch.")
    terms = roofline(flops, hbm_bytes, coll_bytes, chips=1, dtype=dtype)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    if fedsdd:
        so = spec_overrides or {}
        K = dict(zip(axes, dims)).get("pod", 2)
        n_cl = so.get("clients_per_group", 16)
        bsz = so.get("client_batch") or max(1, shape.global_batch // (K * n_cl))
        tokens = K * n_cl * bsz * shape.seq_len
    mult = 6 if shape.kind == "train" or fedsdd else 2
    model_flops = mult * cfg.num_active_params() * tokens
    rec.update({
        "chips": chips,
        "counted": COUNTED,
        "dtype": dtype,
        "step_kind": "fedsdd_round" if fedsdd else shape.kind,
        "n_super": n_super,
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm_bytes,
        "collective_bytes_per_chip": coll_bytes,
        "collectives": coll_kinds,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "num_params": cfg.num_params(),
        "num_active_params": cfg.num_active_params(),
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / (flops * chips)) if flops else None,
        "shallow_raw": {"d1": {k: r1[k] for k in ("flops", "bytes", "coll_bytes", "compile_s")},
                        "d2": {k: r2[k] for k in ("flops", "bytes", "coll_bytes", "compile_s")}},
    })
    if fedsdd:
        rec["teacher_all_reduce_bytes"] = (full or r2)["teacher_all_reduce_bytes"]
    if full is not None:
        rec.update({
            "compile_s": full["compile_s"],
            "lower_s": full["lower_s"],
            "scan_raw_flops_per_chip": full["flops"],
            "collective_counts_scan_body": full["coll_counts"],
            "memory_analysis": _mem_dict(full["mem"]),
        })
    if extra_tag:
        rec["tag"] = extra_tag
    return rec


def _mem_dict(mem):
    """The reference's ``memory_analysis`` keys that the count has (and the
    peak of the live bytes, arguments included)."""
    if mem is None:
        return None
    return {k: int(v) for k, v in mem.items()}


def save_rec(rec: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = rec.get("tag")
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("fedsdd"):
        name += "__fedsdd"
    if tag:
        name += f"__{tag}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fedsdd", action="store_true",
                    help="dry-run the FedSDD round step instead")
    ap.add_argument("--proof-only", action="store_true",
                    help="the full program's counts only, no shallow depths")
    ap.add_argument("--redo", action="store_true",
                    help="recompute combos whose artifact already exists")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = f"{arch}__{shape}__{_mesh_tag(mp)}"
                if args.fedsdd:
                    name += "__fedsdd"
                if args.tag:
                    name += f"__{args.tag}"
                if not args.redo and os.path.exists(
                        os.path.join(args.out, name + ".json")):
                    print(f"HAVE  {arch} {shape} {_mesh_tag(mp)}", flush=True)
                    continue
                try:
                    rec = lower_one(arch, shape, multi_pod=mp,
                                    fedsdd=args.fedsdd, extra_tag=args.tag,
                                    proof_only=args.proof_only or mp)
                    path = save_rec(rec, args.out)
                    if not rec["supported"]:
                        print(f"SKIP  {arch} {shape} {rec['mesh']}: {rec['skip_reason']}",
                              flush=True)
                        continue
                    if rec.get("proof_only"):
                        print(f"OK    {arch} {shape} {rec['mesh']} [proof]"
                              f" run={rec.get('compile_s')}s -> {path}", flush=True)
                        continue
                    print(f"OK    {arch} {shape} {rec['mesh']}"
                          f" run={rec.get('compile_s')}s"
                          f" flops/chip={rec['flops_per_chip']:.3e}"
                          f" coll={rec['collective_bytes_per_chip']/1e6:.1f}MB"
                          f" dominant={rec['dominant']} -> {path}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"FAIL  {arch} {shape} multi_pod={mp}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
