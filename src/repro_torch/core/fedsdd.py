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
reference.  An option the reference takes but this port does not run
yet raises ``NotImplementedError`` naming the slice that brings it,
after the reference's own checks; nothing runs something else quietly.

Everything runs on one device, ``cuda`` unless the caller passes
``device="cpu"``: the task's tensors, the K global models, the teacher
ring and the KD cache.  The round's rng is numpy, seeded as the
reference's, so a round samples, groups and batches exactly as the JAX
runner does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import round_plan
from repro_torch.core.aggregation import fedavg_aggregate
from repro_torch.core.client_store import InMemoryStore, make_client_store
from repro_torch.core.engine import (VectorizedClientEngine, aggregate_groups,
                                     build_round_entries, entry_pad_hints,
                                     plan_from_entries, stack_models, unstack_models)
from repro_torch.core.grouping import assign_groups, sample_clients
from repro_torch.distill import KDPipeline, TeacherBank
from repro_torch.optim.optimizers import (Optimizer, apply_updates, scaffold_new_control,
                                          sgd, value_and_grad, with_fedprox,
                                          with_scaffold)
from repro_torch.utils.pytree import tree_map, tree_stack, tree_zeros_like

PyTree = Any

# the reference's robust aggregators (repro/core/robust_agg.py); only the
# weighted mean is ported
AGGREGATORS = ("mean", "trimmed_mean", "median", "krum", "multi_krum")


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
    faults: Optional[Any] = None    # the reference's FaultPlan
    aggregator: str = "mean"        # mean | trimmed_mean | median | krum | multi_krum
    trim_frac: float = 0.2
    clip_norm: Optional[float] = None
    teacher_trust: bool = False
    # misc
    secure_aggregation: bool = False
    seed: int = 0

    def validate(self) -> None:
        """Reject inconsistent configs with the reference's ``ValueError``s,
        then options this port does not run yet with ``NotImplementedError``."""
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
        _choice("overlap", ("off", "async", "fused"))
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
        for unported, slice_ in self._unported():
            if unported:
                raise NotImplementedError(
                    f"FedConfig: {slice_}; this slice of the port runs the "
                    f"sequential and vectorized engines with the fused KD "
                    f"pipeline, dense or Flash-KD")

    def _unported(self):
        """(condition, what and which later slice brings it) for each valid
        option the port does not run yet."""
        return (
            (self.client_sharding == "shard_map",
             "client_sharding='shard_map' (the client axis over several cards) "
             "arrives with the torch.distributed slice; on one card 'auto' and "
             "'vmap' run vmap"),
            (self.overlap != "off",
             f"overlap={self.overlap!r} arrives with the overlap slice"),
            (self.kd_pipeline == "legacy",
             "kd_pipeline='legacy' (the host-loop oracle, core/distillation.py) "
             "arrives with its own slice; the fused pipeline is held directly "
             "against the JAX package"),
            (self.client_store == "spilling",
             "client_store='spilling' arrives with the robustness slice"),
            (self.faults is not None,
             "faults arrive with the robustness slice"),
            (self.aggregator != "mean" or self.clip_norm is not None,
             "robust aggregation (aggregator != 'mean', clip_norm) arrives "
             "with the robustness slice"),
            (self.teacher_trust,
             "teacher_trust arrives with the robustness slice"),
            (self.secure_aggregation,
             "secure_aggregation arrives with the robustness slice (its masks "
             "are drawn with jax.random, which no port matches bit for bit)"),
            (self.ensemble_extra_sampled > 0,
             "ensemble_extra_sampled > 0 (FedBE) arrives with the robustness "
             "slice (its posterior draws use jax.random)"),
        )


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
    store: Optional[InMemoryStore] = None
    scaffold_c_global: Optional[PyTree] = None
    history: list[dict] = field(default_factory=list)


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
        if cfg.execution == "vectorized":
            self._make_engine()          # an unported step mode raises here

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
        if self._train_step is None:
            optimizer = self._make_optimizer()
            loss_and_grad = value_and_grad(self.task.loss_fn, has_aux=True)

            def step(params, opt_state, batch):
                (loss, _), grads = loss_and_grad(params, batch)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                return apply_updates(params, updates), opt_state, loss

            self._train_step = (optimizer, step)
        return self._train_step

    def _store(self, state: FedState) -> InMemoryStore:
        """The state's client store; states built by hand (tests) get one
        lazily."""
        if state.store is None:
            state.store = make_client_store(self.cfg, self.task)
            if self.cfg.local_algo == "scaffold":
                state.store.init_controls(state.global_models[0])
        return state.store

    def _local_train_scheduled(self, params: PyTree, client_id: int,
                               state: FedState, idx_rows) -> PyTree:
        """One client's local training over a pre-drawn minibatch schedule
        (one index row per step, from ``engine.build_round_entries``).
        ``params`` are the group's global tensors: every step is out of
        place, so they stay as they were for the group's next client."""
        cfg = self.cfg
        store = self._store(state)
        ds = store.client_shard(client_id)
        optimizer, step = self._train_batch_step()
        opt_state = optimizer.init(params)
        if cfg.local_algo == "fedprox":
            opt_state["anchor"] = params
        if cfg.local_algo == "scaffold":
            opt_state = opt_state._replace(
                c_local=store.get_control(client_id),
                c_global=state.scaffold_c_global)
        w_start = params
        for row in idx_rows:
            batch = self.task.make_batch(ds, row)
            params, opt_state, _ = step(params, opt_state, batch)
        if cfg.local_algo == "scaffold":
            store.put_control(client_id, scaffold_new_control(
                opt_state, w_start, params, cfg.client_lr))
        return params

    # ---- vectorized engine ----------------------------------------------
    def _make_engine(self) -> VectorizedClientEngine:
        if self._engine is None:
            self._engine = VectorizedClientEngine(
                self.task.loss_fn, self._make_optimizer(),
                client_sharding=self.cfg.client_sharding)
        return self._engine

    # ---- distillation phase (Eq. 3-4) -------------------------------------
    def _kd_pipeline(self) -> KDPipeline:
        if self._kd_pipe is None:
            cfg = self.cfg
            self._kd_pipe = KDPipeline(
                self.task.logits_fn, steps=cfg.distill_steps, lr=cfg.server_lr,
                temperature=cfg.temperature, device=self.device,
                kd_kernel=cfg.kd_kernel, cache_dtype=cfg.teacher_cache_dtype,
                features_fn=self.task.features_fn, head_fn=self.task.head_fn,
                head_fusion=cfg.kd_head_fusion)
        return self._kd_pipe

    def _executor(self) -> round_plan.RoundExecutor:
        if self._exec is None:
            self._exec = round_plan.RoundExecutor(self)
        return self._exec

    def _distill_models(self, new_globals: list[PyTree], teachers: list[PyTree], *,
                        stacked_students: PyTree | None = None) -> dict:
        """Distill the round's targets in place; returns the KD record.
        ``teachers``: the list of member trees; the pipeline reads one member
        at a time, so a list of views into the ring is never copied.
        ``stacked_students``: the (K, ...) stack of ``new_globals`` when the
        caller has one (the vectorized engine)."""
        pipe = self._kd_pipeline()
        if self.cfg.distill_target == "all":
            if stacked_students is None:
                stacked_students = tree_stack(new_globals)
            out, kd_info = pipe.distill_all(stacked_students, teachers,
                                            self.task.server_batches)
            new_globals[:] = unstack_models(out)
        else:
            new_globals[0], kd_info = pipe.distill(new_globals[0], teachers,
                                                   self.task.server_batches)
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
        """Nothing is deferred with ``overlap='off'``; kept so callers of
        the reference's API work unchanged."""
        return state

    def run(self, rounds: int | None = None, log_every: int = 0,
            state: FedState | None = None) -> FedState:
        state = state or self.init_state()
        for _ in range(rounds or self.cfg.rounds):
            state = self.run_round(state)
            if log_every and state.round % log_every == 0:
                rec = state.history[-1]
                print(f"[round {rec['round']:3d}] " +
                      " ".join(f"{k}={v}" for k, v in rec.items() if k != "round"))
        return self.finalize(state)


# =====================================================================
# per-engine phase bodies (consumed by round_plan.RoundExecutor)
# =====================================================================
class _SequentialRoundOps:
    """The oracle per-client Python loop, split into executor phases."""

    def __init__(self, runner, state, groups, rng, t):
        self.runner, self.state = runner, state
        self.groups, self.t = groups, t
        self.entries = build_round_entries(runner.task, runner.cfg, groups, rng,
                                           store=runner._store(state))
        self.models: list = [None] * len(self.entries)   # by round position

    def train(self) -> None:
        state = self.state
        for e in self.entries:
            self.models[e.pos] = self.runner._local_train_scheduled(
                state.global_models[e.group], e.cid, state, e.idx)

    def finish_local(self) -> None:
        if self.runner.cfg.local_algo == "scaffold":
            # server control: the running-average form, c = mean of client controls
            self.state.scaffold_c_global = self.state.store.control_mean()

    def aggregate(self) -> list[PyTree]:
        """Per-group Eq. 1-2 over the trained client models.  Only FedDF's
        client ensemble reads the client models after this, so otherwise
        they are released here, before the KD phase allocates."""
        new_globals: list[PyTree] = []
        for k in range(len(self.groups)):
            ents = [e for e in self.entries if e.group == k]
            new_globals.append(fedavg_aggregate([self.models[e.pos] for e in ents],
                                                [e.n for e in ents]))
        if self.runner.cfg.ensemble_source != "clients":
            self.models = None
        self.new_globals = new_globals
        return new_globals

    def push(self, t: int, state) -> None:
        state.ensemble.push(t, self.new_globals)

    def inline_kd(self, new_globals) -> dict:
        runner, state = self.runner, self.state
        if runner.cfg.ensemble_source == "clients":
            return runner._distill_models(new_globals, list(self.models))
        # the views are read before the next push
        return runner._distill_models(new_globals, state.ensemble.member_views())


class _VectorizedRoundOps:
    """The stacked engine's phase bodies: every bucket of the round trains
    as one vmapped program, and Eq. 2 for all K groups runs as one pass over
    the round-ordered client stack (``aggregate_groups``)."""

    def __init__(self, runner, state, groups, rng, t):
        self.runner, self.state = runner, state
        self.groups, self.t = groups, t
        self.eng = runner._make_engine()
        self.store = runner._store(state)
        self.entries = build_round_entries(runner.task, runner.cfg, groups, rng,
                                           store=self.store)
        self.pad_hints = entry_pad_hints(self.entries)

    def train(self) -> None:
        runner, state, cfg = self.runner, self.state, self.runner.cfg
        optimizer, dev = self.eng.optimizer, runner.device
        # pin the round's clients resident while their bucket stacks are
        # assembled and consumed
        with self.store.sampled_view([e.cid for e in self.entries]) as view:
            rplan = plan_from_entries(runner.task, self.entries, self.groups,
                                      store=self.store, pad_to=self.pad_hints)
            stacked_k = stack_models(state.global_models)   # (K, ...)

            def init_params_for(plan):
                gid = torch.from_numpy(plan.group_of).to(dev)
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

            self.stacked, self.gids, self.sizes, self.buckets = self.eng.train_round(
                rplan, init_params_for, init_opt_state_for)

    def finish_local(self) -> None:
        state, cfg = self.state, self.runner.cfg
        if cfg.local_algo == "scaffold":
            for plan, p, s, w0 in self.buckets:
                # each client's K is its count of real (unmasked) steps
                new_c = scaffold_new_control(s._replace(steps=plan.step_mask.sum(1)),
                                             w0, p, cfg.client_lr)
                for i, cid in enumerate(plan.cids):
                    self.store.put_control(int(cid), tree_map(lambda x, i=i: x[i], new_c))
            state.scaffold_c_global = self.store.control_mean()

    def aggregate(self) -> list[PyTree]:
        """Eq. 2 for every group at once over the round-ordered client stack."""
        self.stacked_globals = aggregate_groups(self.stacked, self.sizes, self.gids,
                                                self.runner.cfg.K)
        self.new_globals = unstack_models(self.stacked_globals)
        return self.new_globals

    def push(self, t: int, state) -> None:
        # the (K, ...) stack goes into the bank as it is (Eq. 5)
        state.ensemble.push(t, self.stacked_globals)

    def inline_kd(self, new_globals) -> dict:
        runner, state = self.runner, self.state
        if runner.cfg.ensemble_source == "clients":
            teachers = unstack_models(self.stacked)  # FedDF: the client models
        else:
            teachers = state.ensemble.member_views()   # read before the next push
        return runner._distill_models(new_globals, teachers,
                                      stacked_students=self.stacked_globals)


def make_runner(preset: str, task: FedTask, device=None, **overrides) -> FederatedRunner:
    return FederatedRunner(make_config(preset, **overrides), task, device=device)
