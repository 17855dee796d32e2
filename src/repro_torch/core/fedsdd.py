"""FedSDD (Algorithm 1) and the paper's baselines as one runner (port of
``repro/core/fedsdd.py``: the sequential and vectorized client engines with
the fused KD pipeline, dense or Flash-KD).

A single ``FedConfig`` spans the paper's experimental matrix; each
baseline is a preset:

    FedAvg    = K=1, distill_target='none'
    FedProx   = FedAvg + local_algo='fedprox'
    SCAFFOLD  = FedAvg + local_algo='scaffold'
    FedDF     = K=1, distill_target='main', ensemble_source='clients'
    Fed-ensemble = K>1, distill_target='none'
    FedSDD    = K>1, R≥1, distill_target='main', ensemble_source='aggregated'
    Table-6 "basic distillation" = FedSDD + distill_target='all'

``FedConfig`` keeps every field and every ``ValueError`` of the
reference.  ``overlap="async"|"fused"`` defers each round's KD into the next
round's k>0 training (``core/round_plan.py``); ``kd_pipeline="legacy"`` runs
the host-loop oracle (``core/distillation.py``) instead of the fused
``KDPipeline``.  Robustness: ``faults`` (a ``core/faults.py`` ``FaultPlan``)
drops, truncates, corrupts and attacks clients from a seed; Eq. 2 then runs
over the survivors of the isfinite guard, or as a Byzantine-robust
statistic (``aggregator``, ``clip_norm``: ``core/robust_agg.py``);
``teacher_trust`` weights the KD teachers by their agreement; the
spilling client store keeps O(sampled) clients resident; and
``save_state`` / ``restore_state`` checkpoint the whole state, a pending KD
job included, so that a killed run resumes bit for bit.  FedBE
(``ensemble_extra_sampled``) adds Gaussian posterior samples around the
clients' mean and the main aggregate to the client teachers;
``secure_aggregation`` averages masked uploads on the sequential engine
(the reference's vectorized Eq. 2 never masks, and neither does the
port's: there the flag runs plain Eq. 2).

Each process runs on one device, ``cuda`` unless the caller passes
``device="cpu"``: the task's tensors, the K global models, the teacher
ring and the KD cache.  The round's rng is numpy, seeded as the
reference's, so a round samples, groups and batches exactly as the JAX
runner does.  Under ``torch.distributed`` (one process a rank, each
running this runner from the same seed) ``client_sharding`` splits the
vectorized engine's client axis and the KD pipeline's teacher members
over the ranks of ``launch.mesh.make_client_mesh()``, as the reference's
``shard_map`` splits them over devices (``"auto"``: over more than one
rank); everything else every rank computes alike.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import distillation, round_plan
from repro_torch.core import faults as faults_lib
from repro_torch.core.aggregation import (fedavg_aggregate, fedavg_aggregate_grouped_masked,
                                         secure_aggregate)
from repro_torch.core.client_store import ClientStore, make_client_store
from repro_torch.core.engine import (VectorizedClientEngine, aggregate_groups,
                                     build_round_entries, entry_pad_hints,
                                     plan_from_entries, stack_models, unstack_models)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.grouping import assign_groups, sample_clients
from repro_torch.core.robust_agg import AGGREGATORS, robust_aggregate_grouped
from repro_torch.core.step_graph import StepGraphs, copy_into, shape_key, static_like
from repro_torch.distill import KDPipeline, TeacherBank
from repro_torch.fedckpt import checkpointer as fedckpt
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.optim.optimizers import (Optimizer, advance_steps, apply_updates,
                                          scaffold_new_control, sgd, value_and_grad,
                                          with_fedprox, with_scaffold)
from repro_torch.utils.pytree import (seeded_normal, tree_concat, tree_leaves, tree_map,
                                      tree_stack, tree_zeros_like)

PyTree = Any


# =====================================================================
# configuration
# =====================================================================
@dataclass(frozen=True)
class FedConfig:
    # structure (paper defaults, §4.1)
    num_clients: int = 20
    participation: float = 0.4
    rounds: int = 100
    K: int = 4                      # number of global models
    R: int = 1                      # temporal-ensembling checkpoints
    # local training
    local_epochs: int = 40
    client_lr: float = 0.8
    client_batch: int = 64
    client_momentum: float = 0.0
    local_algo: str = "fedavg"      # fedavg | fedprox | scaffold
    fedprox_mu: float = 0.001
    # distillation
    distill_target: str = "main"    # main | all | none
    ensemble_source: str = "aggregated"   # aggregated | clients
    ensemble_extra_sampled: int = 0       # FedBE-style posterior samples
    distill_steps: int = 5000
    server_lr: float = 0.1
    server_batch: int = 256
    temperature: float = 4.0
    distill_warmup_rounds: int = 0  # codistillation-style KD skip
    # execution engine
    execution: str = "sequential"   # sequential (oracle) | vectorized
    client_sharding: str = "auto"   # auto | vmap | shard_map
    kd_pipeline: str = "fused"      # fused (one program) | legacy (oracle)
    kd_kernel: str = "dense"        # dense (oracle) | flash
    teacher_cache_dtype: Optional[str] = None  # None (auto) | float32 | bfloat16
    kd_head_fusion: bool = False
    overlap: str = "off"            # off (oracle) | async | fused
    teacher_dtype: Optional[str] = None   # None (keep) | float32 | bfloat16
    client_store: str = "memory"    # memory (oracle) | spilling
    client_store_dir: Optional[str] = None
    client_cache_buckets: int = 64
    # seeded fault injection (core/faults.py): None is the clean world; a
    # plan whose rates are all zero is bit-identical to None
    faults: Optional[FaultPlan] = None
    # Byzantine-robust Eq. 2 (core/robust_agg.py); clip_norm composes with
    # every aggregator, the mean included
    aggregator: str = "mean"        # mean | trimmed_mean | median | krum | multi_krum
    trim_frac: float = 0.2
    clip_norm: Optional[float] = None
    teacher_trust: bool = False     # trust-weighted KD teachers (fused pipeline)
    # misc
    secure_aggregation: bool = False
    seed: int = 0

    def validate(self) -> None:
        """Reject inconsistent configs with the reference's ``ValueError``s."""
        def _require(ok: bool, msg: str) -> None:
            if not ok:
                raise ValueError(f"invalid FedConfig: {msg}")

        def _choice(name: str, allowed: tuple) -> None:
            _require(getattr(self, name) in allowed,
                     f"{name}={getattr(self, name)!r} not in {allowed}")

        _require(self.K >= 1, f"K={self.K} but need at least one global "
                 "model (K>=1)")
        _require(self.R >= 1, f"R={self.R} but the temporal ensemble "
                 "needs at least the current round (R>=1)")
        _choice("distill_target", ("main", "all", "none"))
        _choice("ensemble_source", ("aggregated", "clients"))
        _choice("local_algo", ("fedavg", "fedprox", "scaffold"))
        _choice("execution", ("sequential", "vectorized"))
        _choice("client_sharding", ("auto", "vmap", "shard_map"))
        _choice("kd_pipeline", ("legacy", "fused"))
        _choice("kd_kernel", ("dense", "flash"))
        if self.kd_head_fusion:
            _require(self.kd_kernel == "flash",
                     "kd_head_fusion streams the LM-head matmul through "
                     "the flash vocab tiles — the dense prob path "
                     "materializes full student rows by construction; set "
                     "kd_kernel='flash'")
        _choice("teacher_cache_dtype", (None, "float32", "bfloat16"))
        if self.teacher_cache_dtype is not None:
            _require(self.kd_kernel == "flash",
                     "teacher_cache_dtype selects the flash mean-logit "
                     "cache precision — the dense oracle's prob cache is "
                     "f32-only; set kd_kernel='flash' or drop the dtype")
            _require(self.kd_pipeline == "fused",
                     "the compressed teacher cache lives in the fused "
                     "KDPipeline; the legacy host loop keeps f32 rows, so "
                     "a cache dtype there would be silently inert")
        _choice("overlap", round_plan.OVERLAP_MODES)
        _choice("teacher_dtype", (None, "float32", "bfloat16"))
        if self.overlap != "off":
            _require(self.kd_pipeline == "fused",
                     "overlapped rounds dispatch KD as one device "
                     "program — the host-driven kd_pipeline='legacy' loop "
                     "cannot overlap; set kd_pipeline='fused' or "
                     "overlap='off'")
        if self.distill_target != "none" and self.ensemble_source == "clients":
            _require(not self.secure_aggregation,
                     "client-model ensembles (FedDF/FedBE) are "
                     "incompatible with secure aggregation — the FedSDD "
                     "privacy argument (§3.2); use "
                     "ensemble_source='aggregated'")
        _choice("client_store", ("memory", "spilling"))
        _require(self.client_cache_buckets >= 1,
                 f"client_cache_buckets={self.client_cache_buckets} but "
                 "the store needs at least one resident bucket")
        if self.client_store_dir is not None:
            _require(self.client_store == "spilling",
                     "client_store_dir names the spill directory, which "
                     "only the spilling store uses; set "
                     "client_store='spilling' or drop the directory")
        if self.faults is not None:
            self.faults.validate()
            _require(not (self.faults.active and self.secure_aggregation),
                     "client faults under secure aggregation need mask "
                     "recovery for the dropped clients' pairwise shares "
                     "(Bonawitz et al. §7) — not simulated here; disable "
                     "secure_aggregation or zero the client fault rates")
        _choice("aggregator", AGGREGATORS)
        _require(0.0 <= self.trim_frac < 0.5,
                 f"trim_frac={self.trim_frac} must be in [0, 0.5) — "
                 "trimming half or more from each end leaves no clients "
                 "(use aggregator='median' for the 50% limit)")
        if self.clip_norm is not None:
            _require(self.clip_norm > 0,
                     f"clip_norm={self.clip_norm} must be > 0 — it is the "
                     "clip radius as a multiple of the group's median "
                     "update norm (None disables clipping)")
        if self.aggregator != "mean" or self.clip_norm is not None:
            _require(not self.secure_aggregation,
                     "robust aggregation needs the individual client "
                     "updates, but secure aggregation makes every single "
                     "upload indistinguishable from noise by design "
                     "(Bonawitz et al.) — order statistics over masked "
                     "uploads are meaningless; use aggregator='mean' "
                     "without clip_norm, or disable secure_aggregation")
            _require(self.faults is None or not self.faults.zero_fill,
                     "zero_fill is an ablation of the WEIGHTED mean "
                     "(unrenormalized Eq. 2); robust order statistics "
                     "have no weight mass to zero-fill — drop zero_fill "
                     "or use aggregator='mean'")
        if self.teacher_trust:
            _require(self.kd_pipeline == "fused",
                     "teacher_trust computes agreement weights over the "
                     "stacked teacher bank inside the fused KD cache "
                     "build; the legacy host loop has no weighted cache — "
                     "set kd_pipeline='fused'")
            _require(self.distill_target != "none",
                     "teacher_trust weights the KD ensemble, but "
                     "distill_target='none' never distills — enable KD or "
                     "drop teacher_trust")


PRESETS: dict[str, dict] = {
    "fedavg":       dict(K=1, distill_target="none"),
    "fedprox":      dict(K=1, distill_target="none", local_algo="fedprox"),
    "scaffold":     dict(K=1, distill_target="none", local_algo="scaffold"),
    "feddf":        dict(K=1, distill_target="main", ensemble_source="clients"),
    "fedbe":        dict(K=1, distill_target="main", ensemble_source="clients",
                         ensemble_extra_sampled=10),
    "fed_ensemble": dict(K=4, distill_target="none"),
    "fedsdd":       dict(K=4, R=1, distill_target="main",
                         ensemble_source="aggregated"),
    "fedsdd_basic_kd": dict(K=4, R=1, distill_target="all",
                            ensemble_source="aggregated"),
}


def make_config(preset: str, **overrides) -> FedConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    return FedConfig(**base)


# =====================================================================
# task plumbing
# =====================================================================
@dataclass
class FedTask:
    """What the runner needs to know about the learning problem.
    ``init_fn`` takes a ``torch.Generator`` and draws on its device;
    ``device`` is where the task keeps its tensors."""
    init_fn: Callable[[torch.Generator], PyTree]
    loss_fn: Callable[[PyTree, Any], tuple[torch.Tensor, dict]]
    logits_fn: Callable[[PyTree, Any], torch.Tensor]
    client_data: Sequence[Any]           # per-client (x, y) numpy pairs
    server_batches: Sequence[Any]        # unlabeled batches for KD, on the device
    make_batch: Callable[[Any, np.ndarray], Any]  # (client_ds, idx) -> batch
    eval_fn: Optional[Callable[[PyTree], float]] = None
    device: Optional[torch.device] = None
    # optional features/head split of logits_fn (LM tasks): enables the
    # head-fused Flash-KD path (FedConfig.kd_head_fusion), where the student
    # (B, V) logit row never exists.  Contract: logits_fn(p, b) ==
    # features_fn(p, b) @ W (+ bias) for head_fn(p) = (W, bias)
    features_fn: Optional[Callable[[PyTree, Any], torch.Tensor]] = None
    head_fn: Optional[Callable[[PyTree], tuple]] = None


@dataclass
class FedState:
    round: int
    global_models: list[PyTree]          # index 0 = main global model
    ensemble: TeacherBank                # device-resident K·R teacher ring
    store: Optional[ClientStore] = None
    scaffold_c_global: Optional[PyTree] = None
    history: list[dict] = field(default_factory=list)
    # overlap modes: the deferred round-t KD job (resolved in round t+1,
    # drained by FederatedRunner.finalize), and the newest resolved
    # (round_idx, distilled main model): global_models[0] is the raw
    # aggregate until its KD resolves
    pending_kd: Optional[round_plan.PendingKD] = None
    last_distilled: Optional[tuple] = None


# =====================================================================
# runner
# =====================================================================
class FederatedRunner:
    def __init__(self, cfg: FedConfig, task: FedTask, device=None):
        cfg.validate()
        self.cfg = cfg
        self.task = task
        self.device = device_lib.resolve(device)
        if task.device is not None and torch.device(task.device) != self.device:
            raise ValueError(f"the task's tensors are on {task.device} but the "
                             f"runner runs on {self.device}; pass the same device "
                             f"to both")
        self._train_step = None
        self._engine = None
        self._kd_pipe = None
        self._exec = None
        # the scan mode's step programs (client steps, bucket steps, KD
        # steps): one graph memory pool for the runner; the sequential
        # client step's "auto" is "stepped" off a card
        self.graphs = StepGraphs()
        if cfg.execution == "vectorized":
            self._make_engine()
        if cfg.faults is not None and cfg.faults.spill_fail > 0:
            # chaos I/O: every fedckpt write and read goes through the plan's
            # first-attempt failures (a process-wide hook: the caller clears
            # it with fedckpt.set_io_fault_injector(None))
            fedckpt.set_io_fault_injector(cfg.faults.io_injector())

    # ---- init ----------------------------------------------------------
    def init_state(self) -> FedState:
        """K models drawn one after the other from one generator seeded
        with ``cfg.seed`` on the runner's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        models = [self.task.init_fn(gen) for _ in range(cfg.K)]
        state = FedState(
            round=0,
            global_models=models,
            ensemble=TeacherBank(cfg.K, cfg.R, dtype=cfg.teacher_dtype),
            store=make_client_store(cfg, self.task),
        )
        if cfg.local_algo == "scaffold":
            state.store.init_controls(models[0])
            state.scaffold_c_global = tree_zeros_like(models[0])
        return state

    # ---- local training --------------------------------------------------
    def _make_optimizer(self) -> Optimizer:
        cfg = self.cfg
        base = sgd(cfg.client_lr, momentum=cfg.client_momentum)
        if cfg.local_algo == "fedprox":
            return with_fedprox(base, cfg.fedprox_mu)
        if cfg.local_algo == "scaffold":
            return with_scaffold(base, cfg.client_lr)
        return base

    def _train_batch_step(self):
        """``(optimizer, step, step_)``: one client step out of place, and the
        same step in place on a step program's buffers."""
        if self._train_step is None:
            optimizer = self._make_optimizer()
            loss_and_grad = value_and_grad(self.task.loss_fn, has_aux=True)

            def step(params, opt_state, batch):
                (loss, _), grads = loss_and_grad(params, batch)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                return apply_updates(params, updates), opt_state, loss

            def step_(params, opt_state, batch):
                _, grads = loss_and_grad(params, batch)
                optimizer.update_(grads, opt_state, params)

            self._train_step = (optimizer, step, step_)
        return self._train_step

    def _client_program(self, params, opt_state, batch):
        """The client step program for these shapes: the step in place on
        static params, optimiser state and batch."""
        _, _, step_ = self._train_batch_step()
        key = shape_key(params, opt_state, batch)

        def build():
            buf = {"params": self.graphs.shared("model", params), "opt": static_like(opt_state),
                   "batch": static_like(batch)}
            return (lambda: step_(buf["params"], buf["opt"], buf["batch"])), buf

        return self.graphs.program("client/step", key, build)

    def _store(self, state: FedState) -> ClientStore:
        """The state's client store; states built by hand (tests) get one
        lazily."""
        if state.store is None:
            state.store = make_client_store(self.cfg, self.task)
            if self.cfg.local_algo == "scaffold":
                state.store.init_controls(state.global_models[0])
        return state.store

    def _local_train_scheduled(self, params: PyTree, client_id: int,
                               state: FedState, idx_rows,
                               control_out: Optional[dict] = None) -> PyTree:
        """One client's local training over a pre-drawn minibatch schedule
        (one index row per step, from ``engine.build_round_entries``).
        ``params`` are the group's global tensors: every step is out of
        place, so they stay as they were for the group's next client.
        ``control_out``: where given, SCAFFOLD's new control is stashed there
        instead of committed (a faulted round commits survivors' only, after
        the isfinite guard)."""
        cfg = self.cfg
        store = self._store(state)
        ds = store.client_shard(client_id)
        optimizer, step, _ = self._train_batch_step()
        opt_state = optimizer.init(params)
        if cfg.local_algo == "fedprox":
            opt_state["anchor"] = params
        if cfg.local_algo == "scaffold":
            opt_state = opt_state._replace(
                c_local=store.get_control(client_id),
                c_global=state.scaffold_c_global)
        w_start = params
        if self.graphs.scan(self.device):
            # the start params and state go into the program's buffers once;
            # each batch is made on the host and copied in before its step
            prog = None
            for row in idx_rows:
                batch = self.task.make_batch(ds, row)
                if prog is None:
                    prog = self._client_program(params, opt_state, batch)
                    copy_into(prog.buf["params"], params)
                    copy_into(prog.buf["opt"], opt_state)
                copy_into(prog.buf["batch"], batch)
                prog()
            if prog is not None:    # the trained params leave as a copy
                params = tree_map(torch.clone, prog.buf["params"])
                opt_state = advance_steps(opt_state, len(idx_rows))
        else:
            for row in idx_rows:
                batch = self.task.make_batch(ds, row)
                params, opt_state, _ = step(params, opt_state, batch)
        if cfg.local_algo == "scaffold":
            new_c = scaffold_new_control(opt_state, w_start, params, cfg.client_lr)
            if control_out is None:
                store.put_control(client_id, new_c)
            else:
                control_out[int(client_id)] = new_c
        return params

    def local_train(self, params: PyTree, client_id: int, state: FedState,
                    rng: np.random.Generator) -> tuple[PyTree, int]:
        """One client's full local training (``local_epochs`` over its
        shard, the reference's minibatches drawn from ``rng``); returns the
        trained params and the shard's size."""
        cfg = self.cfg
        n = self._store(state).num_examples(client_id)
        bs = min(cfg.client_batch, n)
        rows = []
        for _ in range(cfg.local_epochs):
            order = rng.permutation(n)
            rows += [order[i:i + bs] for i in range(0, n - bs + 1, bs)]
        return self._local_train_scheduled(params, client_id, state, rows), n

    # ---- vectorized engine ----------------------------------------------
    def _make_engine(self) -> VectorizedClientEngine:
        if self._engine is None:
            self._engine = VectorizedClientEngine(
                self.task.loss_fn, self._make_optimizer(), mesh=make_client_mesh(),
                client_sharding=self.cfg.client_sharding, graphs=self.graphs)
        return self._engine

    def _sample_posterior(self, models, sizes, n_samples: int, seed: int) -> list[PyTree]:
        """FedBE-style Gaussian posterior samples around the weighted mean:
        sample i is mean + sqrt(var)·z, var the elementwise unbiased variance
        of ``models`` around the mean and z ``seeded_normal`` draws seeded
        from (seed, i, leaf) (the reference draws from ``jax.random``)."""
        mean = fedavg_aggregate(models, sizes)
        var = tree_map(lambda m, *xs: sum((x - m) ** 2 for x in xs) / max(1, len(xs) - 1),
                       mean, *models)
        out = []
        for i in range(n_samples):
            leaves = iter(range(len(tree_leaves(mean))))
            out.append(tree_map(
                lambda m, v: m + torch.sqrt(v.clamp(min=0)).to(m.dtype)
                * seeded_normal((seed, i, next(leaves)), m.shape, m.device).to(m.dtype),
                mean, var))
        return out

    # ---- distillation phase (Eq. 3-4) -------------------------------------
    def _kd_pipeline(self) -> KDPipeline:
        """The fused KD pipeline.  Its step programs are of the runner's set
        with ``overlap='off'`` (one model-sized buffer for the client and KD
        steps); overlapped, a KD program may be in flight beside a client
        one, so they are of a set of their own (``core/step_graph.py``)."""
        if self._kd_pipe is None:
            cfg = self.cfg
            self._kd_pipe = KDPipeline(
                self.task.logits_fn, steps=cfg.distill_steps, lr=cfg.server_lr,
                temperature=cfg.temperature, device=self.device,
                kd_kernel=cfg.kd_kernel, cache_dtype=cfg.teacher_cache_dtype,
                features_fn=self.task.features_fn, head_fn=self.task.head_fn,
                head_fusion=cfg.kd_head_fusion, mesh=make_client_mesh(),
                teacher_sharding=cfg.client_sharding,
                graphs=self.graphs if cfg.overlap == "off" else self.graphs.separate())
        return self._kd_pipe

    def _teacher_trust_weights(self, state, teachers):
        """The (M,) trust weights of the round's KD ensemble on the device,
        or None with ``teacher_trust`` off: agreement on the probe batch
        (``KDPipeline.trust_weights``) and the ring's degraded log, so that a
        poisoned or carried-forward teacher weighs (down to exactly) zero in
        Eq. 3's mean."""
        if not self.cfg.teacher_trust or not teachers:
            return None
        degraded = (state.ensemble.degraded_mask_stacked()
                    if self.cfg.ensemble_source == "aggregated" else None)
        return self._kd_pipeline().trust_weights(teachers, self.task.server_batches,
                                                 degraded_mask=degraded)

    def _executor(self) -> round_plan.RoundExecutor:
        if self._exec is None:
            self._exec = round_plan.RoundExecutor(self)
        return self._exec

    def _distill_models(self, new_globals: list[PyTree], teachers: list[PyTree], *,
                        stacked_students: PyTree | None = None,
                        teacher_weights=None) -> dict:
        """Distill the round's targets in place; returns the KD record.
        ``teachers``: the list of member trees; the pipeline reads one member
        at a time, so a list of views into the ring is never copied.
        ``stacked_students``: the (K, ...) stack of ``new_globals`` when the
        caller has one (the vectorized engine).  ``teacher_weights``: the
        (M,) trust weights (fused only, as ``FedConfig`` requires)."""
        cfg = self.cfg
        if cfg.kd_pipeline == "legacy":
            kd_info = {}
            for k in (range(cfg.K) if cfg.distill_target == "all" else (0,)):
                new_globals[k], kd_info = distillation.distill(
                    new_globals[k], teachers, self.task.server_batches, self.task.logits_fn,
                    steps=cfg.distill_steps, lr=cfg.server_lr, temperature=cfg.temperature,
                    kd_kernel=cfg.kd_kernel, features_fn=self.task.features_fn,
                    head_fn=self.task.head_fn, head_fusion=cfg.kd_head_fusion)
            return kd_info
        pipe = self._kd_pipeline()
        if cfg.distill_target == "all":
            if stacked_students is None:
                stacked_students = tree_stack(new_globals)
            out, kd_info = pipe.distill_all(stacked_students, teachers,
                                            self.task.server_batches,
                                            teacher_weights=teacher_weights)
            new_globals[:] = unstack_models(out)
        else:
            new_globals[0], kd_info = pipe.distill(new_globals[0], teachers,
                                                   self.task.server_batches,
                                                   teacher_weights=teacher_weights)
        if teacher_weights is not None:
            kd_info = {**kd_info, "teacher_trust": round_plan.trust_record(teacher_weights)}
        return kd_info

    # ---- one round (Algorithm 1) -----------------------------------------
    def run_round(self, state: FedState) -> FedState:
        cfg = self.cfg
        t = state.round + 1
        rng = np.random.default_rng(cfg.seed * 100_000 + t)
        active = sample_clients(cfg.num_clients, cfg.participation, rng)
        groups = assign_groups(active, cfg.K, rng)
        ops_cls = (_VectorizedRoundOps if cfg.execution == "vectorized"
                   else _SequentialRoundOps)
        ops = ops_cls(self, state, groups, rng, t)
        return self._executor().execute(state, t, len(active), ops)

    def finalize(self, state: FedState) -> FedState:
        """Drain the deferred KD job (overlap modes): after this the state is
        what ``overlap='off'`` gives.  ``run`` calls it; a loop of
        ``run_round`` calls it once at its end."""
        self._executor().resolve_pending(state)
        self._executor().close()
        return state

    # ---- pending-KD spill and restore -----------------------------------
    def spill_pending(self, state: FedState, directory: str) -> str | None:
        """Persist the deferred KD job's inputs beside a checkpoint
        (overlap modes; the job may still run on the KD stream and is not
        waited for); the npz path, or None with no job pending."""
        if state.pending_kd is None:
            return None
        return round_plan.spill_pending_kd(directory, state.pending_kd)

    def restore_pending(self, state: FedState, path: str) -> round_plan.PendingKD:
        """Reload a spilled job into ``state``; the next resolve (or
        ``finalize``) issues it again from its inputs, which gives the
        drained result bit for bit.  Its record is the live history record
        of its round where there is one, so the late KD fields land there."""
        pending = round_plan.restore_pending_kd(path, state.global_models[0])
        if state.history and state.history[-1].get("round") == pending.round_idx:
            state.history[-1].update(pending.record)
            pending.record = state.history[-1]
        else:
            state.history.append(pending.record)
        state.pending_kd = pending
        return pending

    # ---- crash-safe full-state checkpoints --------------------------------
    def save_state(self, ckpt: fedckpt.Checkpointer, state: FedState) -> str:
        """One atomic full-state checkpoint at a round boundary: the K
        global models, the teacher ring (with its slot map, cursor and
        degraded log), SCAFFOLD's server control, the spilling store's
        running control sum (as it is: a sum kept up step by step rounds
        otherwise than one rebuilt from the files), the history, and a
        pending KD job's inputs; the store's hot controls are flushed to its
        directory.  ``restore_state`` then continues the run bit for bit
        (SCAFFOLD's per-client controls need the spilling store over a
        directory that outlives the process).  Nothing here waits for the
        KD stream."""
        store = self._store(state)
        tree: dict = {"models": tree_stack(state.global_models)}
        bank_tree, bank_meta = state.ensemble.export_state()
        if bank_tree is not None:
            tree["bank"] = bank_tree
        if state.scaffold_c_global is not None:
            tree["c_global"] = state.scaffold_c_global
        if store.control_sum is not None:
            tree["ctrl_sum"] = store.control_sum
        store.flush()
        pend_path = self.spill_pending(state, ckpt.dir)
        # a resolved job's spill must not outlive it: a restore would run
        # its KD again over a model that already took it
        for p in sorted(glob.glob(os.path.join(ckpt.dir, "pending_kd_r*.npz"))):
            if p != pend_path:
                for q in (p, p.replace(".npz", ".json")):
                    if os.path.exists(q):
                        os.remove(q)
        meta = {"round": int(state.round), "keys": sorted(tree), "bank": bank_meta,
                "history": state.history,
                "pending": os.path.basename(pend_path) if pend_path else None}
        return ckpt.save(state.round, tree, meta=meta)

    def _state_like(self, meta: dict) -> dict:
        """The shapes and dtypes of one full-state checkpoint (its meta's
        ``keys`` say which optional parts it has)."""
        cfg = self.cfg
        template = self.task.init_fn(torch.Generator(device=self.device).manual_seed(cfg.seed))
        keys = set(meta.get("keys", ()))
        like: dict = {"models": tree_map(
            lambda x: torch.zeros((cfg.K,) + tuple(x.shape), dtype=x.dtype, device=x.device),
            template)}
        if "bank" in keys:
            like["bank"] = TeacherBank(cfg.K, cfg.R, dtype=cfg.teacher_dtype).bank_like(template)
        if "c_global" in keys:
            like["c_global"] = tree_zeros_like(template)
        if "ctrl_sum" in keys:
            like["ctrl_sum"] = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                                        template)
        return like

    def restore_state(self, ckpt: fedckpt.Checkpointer) -> Optional[FedState]:
        """A ``FedState`` from the newest loadable full-state checkpoint in
        ``ckpt`` (a corrupt or truncated step is skipped, as
        ``Checkpointer.restore_latest`` does), or None where there is none
        (the caller then starts with ``init_state``)."""
        cfg = self.cfg
        for step in reversed(ckpt.steps()):
            meta = ckpt.load_meta(step)
            if meta is None or "keys" not in meta:
                continue
            try:
                if not ckpt.verify(step):
                    continue
                tree = ckpt.restore(step, self._state_like(meta))
            except Exception:
                continue
            state = FedState(round=int(meta["round"]),
                             global_models=unstack_models(tree["models"]),
                             ensemble=TeacherBank(cfg.K, cfg.R, dtype=cfg.teacher_dtype),
                             store=make_client_store(cfg, self.task),
                             history=[dict(r) for r in meta.get("history", [])])
            state.ensemble.import_state(tree.get("bank"), meta["bank"])
            if cfg.local_algo == "scaffold":
                # init_controls takes in the directory's spilled controls;
                # the checkpointed running sum then replaces the rebuilt one
                state.store.init_controls(state.global_models[0])
                state.scaffold_c_global = tree.get(
                    "c_global", tree_zeros_like(state.global_models[0]))
            if "ctrl_sum" in tree:
                state.store.set_control_sum(tree["ctrl_sum"])
            if meta.get("pending"):
                p = os.path.join(ckpt.dir, meta["pending"])
                if os.path.exists(p):
                    self.restore_pending(state, p)
            return state
        return None

    def run(self, rounds: int | None = None, log_every: int = 0,
            state: FedState | None = None) -> FedState:
        state = state or self.init_state()
        for _ in range(rounds or self.cfg.rounds):
            state = self.run_round(state)
            if log_every and state.round % log_every == 0:
                # overlap modes: the newest record's KD and eval fields land
                # at its resolve, so log the newest complete one
                rec = state.history[-1]
                if state.pending_kd is not None:
                    if len(state.history) < 2:
                        continue
                    rec = state.history[-2]
                print(f"[round {rec['round']:3d}] " +
                      " ".join(f"{k}={v}" for k, v in rec.items() if k != "round"))
        return self.finalize(state)

    # ---- evaluation helpers ----------------------------------------------
    def ensemble_eval_fn(self, state: FedState):
        """The K·R teacher ensemble as a classifier (paper Table 5): a
        function of a batch giving each row's ensemble class.  It holds the
        ring's members as copies, which a later push leaves alone."""
        teachers = state.ensemble.members() or state.global_models
        logits_fn = self.task.logits_fn
        return lambda batch: distillation.ensemble_predict(teachers, batch, logits_fn)


# =====================================================================
# per-engine phase bodies (consumed by round_plan.RoundExecutor)
# =====================================================================
class _SequentialRoundOps:
    """The oracle per-client Python loop, split into executor phases.  The
    ``subset`` of ``train`` ("all", "rest" = groups k>0, "main" = group 0)
    walks the pre-drawn entries in group-major order, so the phase split
    changes when clients train, never what they compute.  Under a fault
    plan a dropped client does not train, a straggler replays fewer steps
    of the same step program, and SCAFFOLD's controls are stashed until the
    isfinite guard has ruled on the uploads."""

    def __init__(self, runner, state, groups, rng, t):
        self.runner, self.state = runner, state
        self.groups, self.t = groups, t
        self.entries = build_round_entries(runner.task, runner.cfg, groups, rng,
                                           store=runner._store(state))
        self.models: list = [None] * len(self.entries)   # by round position
        # None (the unmodified paths) or the round's trace, folded into the
        # entries' schedules
        self.faults = faults_lib.apply_round_faults(runner.cfg.faults, t, self.entries)
        self.fault_info: dict = {}
        self.degraded: list = []
        self._surv = None
        self._ctrl_out = ({} if self.faults is not None and runner.cfg.local_algo == "scaffold"
                          else None)

    def fused_capable(self) -> bool:
        return False    # one client at a time: no bucket step to pair

    def _subset(self, which: str):
        if which == "all":
            return self.entries
        if which == "rest":
            return [e for e in self.entries if e.group != 0]
        return [e for e in self.entries if e.group == 0]

    def train(self, which: str = "all", run_buckets=None) -> None:
        state, rf = self.state, self.faults
        for e in self._subset(which):
            if e.dropped:
                continue                        # a dropped client never reports
            ref = state.global_models[e.group]
            model = self.runner._local_train_scheduled(ref, e.cid, state, e.idx,
                                                       control_out=self._ctrl_out)
            if rf is not None and e.cid in rf.attacked:
                model = faults_lib.attack_model(rf.plan, self.t, e.cid, model, ref)
            if rf is not None and e.cid in rf.corrupt:
                model = faults_lib.poison_model(model)
            self.models[e.pos] = model

    def _survivors(self) -> set:
        """The reporting clients whose upload passes the isfinite guard (one
        host read a client)."""
        if self._surv is None:
            surv, rejected = set(), []
            for e in self.entries:
                if e.dropped:
                    continue
                if faults_lib.all_finite(self.models[e.pos]):
                    surv.add(e.cid)
                else:
                    rejected.append(e.cid)
            self._surv, self._rejected = surv, rejected
        return self._surv

    def finish_local(self) -> None:
        state = self.state
        if self.runner.cfg.local_algo == "scaffold":
            if self._ctrl_out is not None:
                surv = self._survivors()
                for e in self.entries:
                    if e.cid in surv and e.cid in self._ctrl_out:
                        state.store.put_control(e.cid, self._ctrl_out[e.cid])
            # server control: the running-average form, c = mean of client controls
            state.scaffold_c_global = state.store.control_mean()

    def aggregate(self) -> list[PyTree]:
        """Per-group Eq. 1-2 over the trained client models (over the
        survivors under faults: an emptied group carries its model
        forward).  Only FedDF's client ensemble reads the client models
        after this, so otherwise each group's are released as soon as it is
        averaged, and the round holds at most one new global beside the
        clients still to average."""
        cfg, rf = self.runner.cfg, self.faults
        if cfg.aggregator != "mean" or cfg.clip_norm is not None:
            return self._aggregate_robust()
        surv = self._survivors() if rf is not None else None
        new_globals: list[PyTree] = []
        keep = cfg.ensemble_source == "clients"
        for k in range(len(self.groups)):
            ents = [e for e in self.entries if e.group == k]
            live = ents if surv is None else [e for e in ents if e.cid in surv]
            if not live:
                new_globals.append(self.state.global_models[k])
                self.degraded.append(k)
                continue
            if cfg.secure_aggregation:
                # the server sees the masked uploads only (no faults here:
                # FedConfig refuses secure aggregation with active faults)
                agg, _uploads = secure_aggregate([self.models[e.pos] for e in live],
                                                 [e.n for e in live], seed=self.t)
            else:
                agg = fedavg_aggregate([self.models[e.pos] for e in live],
                                       [e.n for e in live])
            if rf is not None and rf.plan.zero_fill:
                frac = sum(e.n for e in live) / sum(e.n for e in ents)
                agg = tree_map(lambda x: (x * frac).to(x.dtype)
                               if x.is_floating_point() else x, agg)
            new_globals.append(agg)
            if not keep:            # a group's client models go once it is averaged
                for e in ents:
                    self.models[e.pos] = None
        if not keep:
            self.models = None
        if rf is not None:
            self.fault_info = faults_lib.fault_record(rf, surv, self._rejected, self.degraded)
        self.new_globals = new_globals
        return new_globals

    def _aggregate_robust(self) -> list[PyTree]:
        """Robust Eq. 2 through the vectorized engine's entry point: the
        round's models stacked in round order (a dropped client's row the
        group's model, under a False mask)."""
        cfg, rf, state = self.runner.cfg, self.faults, self.state
        surv = self._survivors() if rf is not None else None
        mask = np.asarray([surv is None or (not e.dropped and e.cid in surv)
                           for e in self.entries])
        stacked = tree_stack([self.models[e.pos] if self.models[e.pos] is not None
                              else state.global_models[e.group] for e in self.entries])
        if cfg.ensemble_source != "clients":
            self.models = None
        agg, self.degraded = robust_aggregate_grouped(
            stacked, [e.n for e in self.entries], np.asarray([e.group for e in self.entries]),
            len(self.groups), aggregator=cfg.aggregator, trim_frac=cfg.trim_frac,
            clip_norm=cfg.clip_norm, survivor_mask=mask,
            fallback_stacked=tree_stack(state.global_models))
        self.new_globals = unstack_models(agg)
        if rf is not None:
            self.fault_info = faults_lib.fault_record(rf, surv, self._rejected, self.degraded)
        return self.new_globals

    def push(self, t: int, state) -> None:
        state.ensemble.push(t, self.new_globals, degraded=self.degraded)

    def _client_teachers(self, new_globals) -> list:
        """FedDF's teachers: the round's client models, under faults the
        survivors' only (one NaN teacher would poison the ensemble), or the
        carried-forward globals where none survived.  FedBE appends its
        posterior samples around their weighted mean, then the main
        aggregate."""
        cfg, runner = self.runner.cfg, self.runner
        if self.faults is None:
            teachers, sizes = list(self.models), [e.n for e in self.entries]
        else:
            surv = self._survivors()
            live = [e for e in self.entries if e.cid in surv]
            teachers, sizes = [self.models[e.pos] for e in live], [e.n for e in live]
            if not teachers:
                teachers, sizes = list(new_globals), [1] * len(new_globals)
        if cfg.ensemble_extra_sampled:
            teachers += runner._sample_posterior(list(teachers), sizes,
                                                 cfg.ensemble_extra_sampled, self.t)
            teachers.append(new_globals[0])
        return teachers

    def inline_kd(self, new_globals) -> dict:
        runner, state = self.runner, self.state
        if runner.cfg.ensemble_source == "clients":
            teachers = self._client_teachers(new_globals)
        else:
            teachers = state.ensemble.member_views()   # read before the next push
        return runner._distill_models(new_globals, teachers,
                                      teacher_weights=runner._teacher_trust_weights(state,
                                                                                    teachers))

    def kd_teachers(self, new_globals) -> tuple[list, Optional[TeacherBank]]:
        """The deferred job's teachers and the ring they are views of (held
        until the resolve; the next push comes after it), or the client
        models and ``None``."""
        if self.runner.cfg.ensemble_source == "clients":
            return self._client_teachers(new_globals), None
        return self.state.ensemble.member_views(), self.state.ensemble


class _VectorizedRoundOps:
    """The stacked engine's phase bodies: every bucket of the round trains
    as one vmapped program, and Eq. 2 for all K groups runs as one pass over
    the round-ordered client stack (``aggregate_groups``).  A phase split
    trains each subset's buckets apart, padded to the round's pad targets so
    that the subsets' bucket programs keep their shapes across rounds; the
    subsets' stacks go back into round order before the one Eq. 2 launch,
    which then sums in the order the undivided round does.  The pad targets
    are taken before the round's faults truncate schedules, so a faulted
    round replays a clean round's programs (a dropped client trains as a
    wasted lane); attacks and corruption strike the trained stack's rows."""

    def __init__(self, runner, state, groups, rng, t):
        self.runner, self.state = runner, state
        self.groups, self.t = groups, t
        self.eng = runner._make_engine()
        self.store = runner._store(state)
        self.entries = build_round_entries(runner.task, runner.cfg, groups, rng,
                                           store=self.store)
        self.pad_hints = entry_pad_hints(self.entries)
        self.faults = faults_lib.apply_round_faults(runner.cfg.faults, t, self.entries)
        self.fault_info: dict = {}
        self.degraded: list = []
        self._surv = None
        self.results: list = []     # (stacked, gids, sizes, orders, cids) per trained subset
        self.buckets: list = []     # SCAFFOLD's bookkeeping across subsets

    def fused_capable(self) -> bool:
        return self.eng.graphs.scan(self.runner.device)

    def _subset(self, which: str):
        if which == "all":
            return self.entries
        if which == "rest":
            return [e for e in self.entries if e.group != 0]
        return [e for e in self.entries if e.group == 0]

    def train(self, which: str = "all", run_buckets=None) -> None:
        ents = self._subset(which)
        if not ents:
            return
        runner, state, cfg = self.runner, self.state, self.runner.cfg
        optimizer, dev = self.eng.optimizer, runner.device
        # pin the phase's clients resident while their bucket stacks are
        # assembled and consumed
        with self.store.sampled_view([e.cid for e in ents]) as view:
            rplan = plan_from_entries(runner.task, ents, self.groups,
                                      store=self.store, pad_to=self.pad_hints)
            stacked_k = stack_models(state.global_models)   # (K, ...)

            def init_params_for(plan):
                gid = device_lib.to_device(plan.group_of, dev)
                return tree_map(lambda x: x[gid], stacked_k)

            def init_opt_state_for(plan, w0):
                s0 = optimizer.init(w0)
                if cfg.local_algo == "scaffold":
                    nb = len(plan.cids)
                    c_glob = tree_map(lambda x: x.expand((nb,) + tuple(x.shape)),
                                      state.scaffold_c_global)
                    s0 = s0._replace(c_local=tree_stack(view.controls(plan.cids)),
                                     c_global=c_glob)
                return s0

            stacked, gids, sizes, buckets = self.eng.train_round(
                rplan, init_params_for, init_opt_state_for, run_buckets=run_buckets)
        rf = self.faults
        if rf is not None and rf.attacked:
            # the sequential engine's attack arithmetic on this subset's rows
            # (rows in `ents` order: the stack is in round order)
            atk = [(i, e.cid, e.group) for i, e in enumerate(ents) if e.cid in rf.attacked]
            stacked = faults_lib.attack_rows(rf.plan, self.t, stacked, atk,
                                             state.global_models)
        if rf is not None and rf.corrupt:
            stacked = faults_lib.poison_rows(
                stacked, [i for i, e in enumerate(ents) if e.cid in rf.corrupt])
        orders = np.sort(np.concatenate([p.order for p in rplan.plans]))
        cids = np.asarray([e.cid for e in ents])
        self.results.append((stacked, gids, sizes, orders, cids))
        self.buckets.extend(buckets)

    def _survivors(self) -> set:
        """The sequential ops' contract: dropped clients out, then the
        stacked isfinite guard (one (C,) host read a subset) on the rest."""
        if self._surv is None:
            surv, rejected = set(), []
            for stacked, _, _, _, cids in self.results:
                for c, ok in zip(cids, faults_lib.finite_rows(stacked)):
                    c = int(c)
                    if c in self.faults.dropped:
                        continue
                    if ok:
                        surv.add(c)
                    else:
                        rejected.append(c)
            self._surv, self._rejected = surv, sorted(rejected)
        return self._surv

    def finish_local(self) -> None:
        state, cfg = self.state, self.runner.cfg
        if cfg.local_algo == "scaffold":
            surv = self._survivors() if self.faults is not None else None
            for plan, p, s, w0 in self.buckets:
                # each client's K is its count of real (unmasked) steps
                new_c = scaffold_new_control(s._replace(steps=plan.step_mask.sum(1)),
                                             w0, p, cfg.client_lr)
                for i, cid in enumerate(plan.cids):
                    if surv is not None and int(cid) not in surv:
                        continue    # dropped or rejected: its control never lands
                    self.store.put_control(int(cid), tree_map(lambda x, i=i: x[i], new_c))
            state.scaffold_c_global = self.store.control_mean()

    def aggregate(self) -> list[PyTree]:
        """Eq. 2 for every group at once over the round-ordered client stack
        (the subsets' stacks concatenated back into round order): the mean
        (kernel 5 on a card), over the survivors under faults, or a robust
        statistic."""
        if len(self.results) == 1:
            self.stacked, self.gids, self.sizes, _, cids = self.results[0]
        else:
            inv = np.argsort(np.concatenate([r[3] for r in self.results]))
            perm = device_lib.to_device(inv, self.runner.device)
            self.stacked = tree_map(lambda *xs: torch.cat(xs)[perm],
                                    *[r[0] for r in self.results])
            self.gids = np.concatenate([r[1] for r in self.results])[inv]
            self.sizes = np.concatenate([r[2] for r in self.results])[inv]
            cids = np.concatenate([r[4] for r in self.results])[inv]
        self.cids_round = cids
        rf, cfg = self.faults, self.runner.cfg
        robust = cfg.aggregator != "mean" or cfg.clip_norm is not None
        surv = self._survivors() if rf is not None else None
        self.results = []
        # secure_aggregation: the reference's vectorized Eq. 2 averages the
        # raw stack (no masks); the port keeps that behaviour
        if rf is None and not robust:
            self.stacked_globals = aggregate_groups(self.stacked, self.sizes, self.gids, cfg.K)
        else:
            mask = np.asarray([surv is None or int(c) in surv for c in cids])
            fallback = stack_models(self.state.global_models)
            if robust:
                self.stacked_globals, self.degraded = robust_aggregate_grouped(
                    self.stacked, self.sizes, self.gids, cfg.K, aggregator=cfg.aggregator,
                    trim_frac=cfg.trim_frac, clip_norm=cfg.clip_norm, survivor_mask=mask,
                    fallback_stacked=fallback)
            else:
                self.stacked_globals, self.degraded = fedavg_aggregate_grouped_masked(
                    self.stacked, self.sizes, self.gids, cfg.K, mask, fallback,
                    zero_fill=rf.plan.zero_fill)
            if rf is not None:
                self.fault_info = faults_lib.fault_record(rf, surv, self._rejected,
                                                          self.degraded)
        self.new_globals = unstack_models(self.stacked_globals)
        return self.new_globals

    def push(self, t: int, state) -> None:
        # the (K, ...) stack goes into the bank as it is (Eq. 5)
        state.ensemble.push(t, self.stacked_globals, degraded=self.degraded)

    def _client_teachers(self, new_globals) -> list:
        """FedDF's teachers: the round's client models (the survivors' under
        faults, or the carried-forward globals where none survived).  FedBE
        concatenates its posterior samples and the main aggregate onto the
        client stack (``tree_concat``), as the reference does."""
        cfg, runner = self.runner.cfg, self.runner
        stack, sizes = self.stacked, list(self.sizes)
        if self.faults is not None:
            surv = self._survivors()
            keep = [i for i, c in enumerate(self.cids_round) if int(c) in surv]
            if keep:
                ki = device_lib.to_device(torch.tensor(keep, dtype=torch.int64), runner.device)
                stack = tree_map(lambda x: x[ki], stack)
                sizes = [sizes[i] for i in keep]
            else:
                stack, sizes = self.stacked_globals, [1] * cfg.K  # carry-forwards teach
        if cfg.ensemble_extra_sampled:
            extras = runner._sample_posterior(unstack_models(stack), sizes,
                                              cfg.ensemble_extra_sampled, self.t)
            extras.append(new_globals[0])
            stack = tree_concat([stack, tree_stack(extras)])
        return unstack_models(stack)

    def inline_kd(self, new_globals) -> dict:
        runner, state = self.runner, self.state
        if runner.cfg.ensemble_source == "clients":
            teachers = self._client_teachers(new_globals)
        else:
            teachers = state.ensemble.member_views()   # read before the next push
        return runner._distill_models(new_globals, teachers,
                                      stacked_students=self.stacked_globals,
                                      teacher_weights=runner._teacher_trust_weights(state,
                                                                                    teachers))

    def kd_teachers(self, new_globals) -> tuple[list, Optional[TeacherBank]]:
        """As the sequential ops' (the client models: the round's stack)."""
        if self.runner.cfg.ensemble_source == "clients":
            return self._client_teachers(new_globals), None
        return self.state.ensemble.member_views(), self.state.ensemble


def make_runner(preset: str, task: FedTask, device=None, **overrides) -> FederatedRunner:
    return FederatedRunner(make_config(preset, **overrides), task, device=device)
