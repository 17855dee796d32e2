"""Server KD over stacked teachers, paper Eqs. 3-4 (port of
``repro/distill/pipeline.py``: the dense cache and Flash-KD).

One round's distillation phase:

  1. **Teacher cache** — the teachers (upcast to f32 one member at a time)
     forward every server batch.  ``kd_kernel="dense"``: the logits go into
     one ``(M, n_batches, B, V)`` stack and ONE ``ensemble_softmax_many``
     launch turns it into the ``(n_batches, B, V)`` f32 probability cache,
     adding the members in order (newest round first).
     ``kd_kernel="flash"``: the members' logits are summed in that order and
     divided by M into the mean-logit cache, stored in ``cache_dtype``
     (bf16 unless asked otherwise), beside its f32 row normaliser
     ``teacher_cache_lse`` — the pair ``(mean_logits, lse)``, at the true V.
  2. **KD schedule** — ``distill_steps`` SGD steps (momentum 0.9, the
     server optimiser), step ``s`` on batch ``s % n_batches``, each through
     the KD kernels (forward and backward): ``kd_loss`` (dense),
     ``flash_kd_loss`` (flash) or, where the task splits ``logits_fn`` into
     ``features_fn`` and ``head_fn`` and ``head_fusion`` is on,
     ``flash_kd_head_loss``, whose kernels form the student's LM-head tile
     themselves so the (B, V) student row never exists.  A task without
     that split keeps the plain flash path.  Losses stay on the device; ONE
     host pull per round fills the history record.
     ``step_mode="scan"`` (on a card by default, and on the CPU, as in the
     reference) makes one KD step a step program (``core/step_graph.py``):
     a CUDA graph on a card, replayed ``distill_steps`` times.  The step
     counter lives on the device; each step takes its batch index ``s %
     n_batches`` there and reads the server batch and the cache row into
     its own rows with ``index_select``, so one graph serves every batch
     (one graph a batch index would hold a copy of the step's
     intermediates each unless they shared a pool, for no saving: the row
     copy is 0.16 ms at gemma-2b's 512 x 256,000 bf16 row).  The round's
     teacher cache is written straight into the program's cache buffer,
     so it exists once.  The optimiser
     updates the static student and momentum in place, the loss goes into
     a static ``(steps,)`` buffer, and the student leaves as a copy.
     ``"stepped"`` launches each step's ops from Python.
  3. **Multi-student** — ``distill_all`` runs the K students one after the
     other over the same cache and the same step program (the reference
     vmaps them); the reported losses are the main model's.
  4. **Overlapped rounds** — ``distill_async`` issues the whole phase (the
     cache build and every step) on the pipeline's KD lane, a CUDA stream of
     its own, with no host sync, and returns device tensors; its step
     programs' set is then held on that lane (``core/step_graph.py``) until
     ``join``, an event wait of the caller's stream, and ``losses_info``,
     the one host pull.  Tensors cross the two streams under
     ``record_stream``, so the caching allocator never hands one out while
     the other stream may still read it.  On the CPU the lane is a label
     and the phase runs at the call.  ``start_steps`` / ``finish_steps``
     split the scan loop around its steps for the executor's paired
     programs (``overlap="fused"``).

  5. **Trust weights** — ``trust_weights`` gives each of the M teachers a
     weight from its agreement with the others on the probe batch (the
     first server batch) and the ring's degraded log; with
     ``teacher_weights`` the cache is built from the weighted sum Σ w_m z_m
     of the teachers' logits instead of their mean: the dense cache as
     kernel 2 on an M = 1 stack of that sum, the flash cache as the sum
     itself and its normaliser.  Without weights the cache is built as
     before, bit for bit.
  6. **Sharded teacher pass** — with ``teacher_sharding="shard_map"`` (or
     ``"auto"`` over several ranks, ``launch.mesh.use_shard_map``) the M
     members are split over the client mesh's ranks, as the reference's
     ``shard_map`` splits its member axis: padded to a multiple of the rank
     count with zero-weight members, each rank forwards its own block and
     makes a masked f32 logit sum (the normalised trust weights ride the
     mask), ONE all-reduce adds the ranks' sums (the only collective of
     the KD phase: nB·B·V·4 bytes whatever M and the client count), then a
     division by M when the pass is unweighted.  The dense cache is kernel
     2 on an M = 1 stack of that mean, as the reference's; the flash cache
     is the mean in ``cache_dtype`` and its normaliser.  The all-reduce
     runs in the eager teacher pass, never inside a step program.  A padded
     member weighs exactly zero, so it is not forwarded at all.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.analysis.sync import allowed_sync
from repro_torch.core.robust_agg import median
from repro_torch.core.step_graph import (StepGraphs, StepProgram, copy_into, on_lane,
                                         shape_key, static_like)
from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.launch.mesh import all_reduce_sum, mesh_size, use_shard_map
from repro_torch.optim.optimizers import apply_updates, sgd, value_and_grad
from repro_torch.utils.pytree import (tree_cast, tree_leaves, tree_map, tree_stack,
                                      tree_unstack)

PyTree = Any
LogitsFn = Callable[[PyTree, Any], torch.Tensor]
_CACHE_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}

# trust weighting (the reference's constants): a teacher whose normalised
# weight falls below TRUST_FLOOR × uniform is cut to exactly 0; a member
# the ring logs as a carry-forward is discounted by TRUST_DEGRADED_DISCOUNT
TRUST_FLOOR = 0.1
TRUST_DEGRADED_DISCOUNT = 0.5


def stack_server_batches(batches: Sequence[Any]) -> PyTree:
    """Server batch list -> one tree with leaves (n_batches, B, ...).  Task
    builders emit full-size server batches only, so a ragged tail means a
    misbuilt task."""
    try:
        return tree_stack(list(batches))
    except (RuntimeError, TypeError) as e:
        shapes = sorted({tuple(x.shape) for b in batches for x in tree_leaves(b)})
        raise ValueError(
            f"fused KD pipeline needs same-shape server batches (saw leaf "
            f"shapes {shapes}); drop the ragged tail batch") from e


class KDPipeline:
    """One round's distillation phase.  Built once per runner; the stacked
    server batches are cached keyed on the batch list's identity."""

    def __init__(self, logits_fn: LogitsFn, *, steps: int, lr: float,
                 temperature: float = 4.0, momentum: float = 0.9, device=None,
                 kd_kernel: str = "dense", cache_dtype: str | None = None,
                 features_fn: Callable | None = None, head_fn: Callable | None = None,
                 head_fusion: bool = False, step_mode: str = "auto",
                 graphs: StepGraphs | None = None, mesh=None,
                 teacher_sharding: str = "auto"):
        if teacher_sharding not in ("auto", "vmap", "shard_map"):
            raise ValueError(f"teacher_sharding={teacher_sharding!r} not in "
                             "('auto', 'vmap', 'shard_map')")
        if kd_kernel not in ("dense", "flash"):
            raise ValueError(f"kd_kernel={kd_kernel!r} not in ('dense', 'flash')")
        if head_fusion and kd_kernel != "flash":
            raise ValueError(
                "head fusion streams the LM-head matmul through the "
                "flash vocab tiles — the dense prob path has no tiles "
                "to fuse it into")
        if cache_dtype not in _CACHE_DTYPES:
            raise ValueError(f"cache_dtype={cache_dtype!r} not in (None, 'float32', "
                             f"'bfloat16')")
        self.logits_fn = logits_fn
        self.features_fn = features_fn
        self.head_fn = head_fn
        # head fusion engages only where the task exposes the features/head
        # split; tasks whose head is inside logits_fn keep the plain flash path
        self.head_fused = bool(head_fusion and features_fn is not None and head_fn is not None)
        self.kd_kernel = kd_kernel
        # the flash cache holds mean logits, bf16 by default (half the f32
        # bytes); the dense cache holds f32 probabilities only
        if kd_kernel == "flash":
            self.cache_dtype = _CACHE_DTYPES[cache_dtype] or torch.bfloat16
        else:
            if _CACHE_DTYPES[cache_dtype] not in (None, torch.float32):
                raise ValueError("the dense prob cache is f32-only")
            self.cache_dtype = torch.float32
        self.steps = int(steps)
        self.temperature = float(temperature)
        self.optimizer = sgd(lr, momentum=momentum)
        self.device = device_lib.resolve(device)
        self.mesh = mesh
        self.teacher_sharding = teacher_sharding
        # the KD loop's "auto" is "scan" on the CPU too, as in the reference
        self.graphs = (graphs.with_mode(step_mode, "scan") if graphs is not None
                       else StepGraphs(step_mode, "scan"))
        self._batches: PyTree | None = None
        self._batches_src: Sequence[Any] | None = None
        self._lane = None

    # ------------------------------------------------- server batch cache
    def jit_programs(self) -> dict:
        """The KD step programs by label (see ``analysis.TraceGuard``)."""
        return self.graphs.jit_programs("kd/")

    def batches_for(self, server_batches: Sequence[Any]) -> PyTree:
        # identity check against a retained reference: holding the keyed
        # list alive means a same-id reallocation can never alias the cache
        if self._batches_src is not server_batches:
            self._batches = tree_map(lambda x: x.to(self.device),
                                     stack_server_batches(server_batches))
            self._batches_src = server_batches
        return self._batches

    def nbytes(self) -> int:
        """Device bytes of the retained server-batch stack: the KD side of
        the server's residency audit beside ``ClientStore.nbytes()`` and
        ``TeacherBank.nbytes()``; zero before the first round."""
        if self._batches is None:
            return 0
        return sum(x.numel() * x.element_size() for x in tree_leaves(self._batches))

    # --------------------------------------------------- teacher precompute
    def _teacher_logits(self, teachers: Sequence[PyTree], batches):
        """Yield (m, b, logits) for every member m of the teacher list and
        server batch b, each member upcast to f32 on its own (a bf16 ring
        stays half-width)."""
        nB = tree_leaves(batches)[0].shape[0]
        for m, member in enumerate(teachers):
            member = tree_cast(member, torch.float32)
            for b in range(nB):
                yield m, b, self.logits_fn(member, tree_map(lambda x: x[b], batches)).float()

    def _shard_teachers(self) -> bool:
        """Shard decision for the teacher pass: the same shared policy the
        client engine resolves (``launch.mesh.use_shard_map``)."""
        return use_shard_map(self.mesh, self.teacher_sharding)

    @torch.no_grad()
    def _logit_sum(self, teachers: Sequence[PyTree], batches: PyTree,
                   weights: torch.Tensor | None) -> torch.Tensor:
        """(n_batches, B, V) f32 Σ_m mask_m z_m, the members summed in order.
        The mask is 1 (unweighted) or the trust weight normalised to sum 1.
        Sharded, the members are padded to a multiple of the rank count with
        zero-mask ones (not forwarded), each rank sums its own block and ONE
        all-reduce adds the ranks' sums; unsharded, this process is rank 0
        of 1 and sums every member."""
        shard = self._shard_teachers()
        M = len(teachers)
        rows = -(-M // mesh_size(self.mesh)) if shard else M
        lo = self.mesh.rank * rows if shard else 0
        w = None
        if weights is not None:
            w = weights.to(device=self.device, dtype=torch.float32)
            w = w / w.sum().clamp_min(1e-12)
        mine = range(lo, min(lo + rows, M))
        total = None
        for m, b, lg in self._teacher_logits([teachers[i] for i in mine], batches):
            if total is None:
                total = torch.zeros((tree_leaves(batches)[0].shape[0],) + tuple(lg.shape),
                                    dtype=torch.float32, device=lg.device)
            total[b] += lg if w is None else w[lo + m] * lg
        if total is None:       # every member of this rank's block is padding
            shape = tree_leaves(self.cache_like(teachers, batches))[0].shape
            total = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return all_reduce_sum(total, self.mesh) if shard else total

    @torch.no_grad()
    def precompute_teacher_probs(self, teachers: Sequence[PyTree],
                                 batches: PyTree) -> torch.Tensor:
        """M teachers × (n_batches, B, ...) batches -> (n_batches, B, V) f32
        ensemble probabilities, in one ``ensemble_softmax`` launch (sharded:
        on an M = 1 stack of the mean logit)."""
        if self._shard_teachers():
            return kd_ops.ensemble_softmax_many(
                self.precompute_mean_logits(teachers, batches)[None], self.temperature)
        M = len(teachers)
        nB = tree_leaves(batches)[0].shape[0]
        logits = None
        for m, b, lg in self._teacher_logits(teachers, batches):
            if logits is None:
                logits = torch.empty((M, nB) + tuple(lg.shape), dtype=torch.float32,
                                     device=lg.device)
            logits[m, b] = lg
        return kd_ops.ensemble_softmax_many(logits, self.temperature)

    @torch.no_grad()
    def precompute_mean_logits(self, teachers: Sequence[PyTree], batches: PyTree) -> torch.Tensor:
        """(n_batches, B, V) f32 mean teacher logit (Eq. 3's ensemble in the
        logit-sum form), the members summed in order and divided by M."""
        return self._logit_sum(teachers, batches, None).div_(len(teachers))

    @torch.no_grad()
    def precompute_weighted_logits(self, teachers: Sequence[PyTree], batches: PyTree,
                                   weights: torch.Tensor) -> torch.Tensor:
        """(n_batches, B, V) f32 Σ_m w_m z_m, the weights normalised to sum
        1 (the trust-weighted form of Eq. 3's mean logit), summed in member
        order on the device."""
        return self._logit_sum(teachers, batches, weights)

    def precompute_cache(self, teachers: Sequence[PyTree], batches: PyTree, out=None,
                         weights: torch.Tensor | None = None):
        """The tensor the KD steps consume: the (n_batches, B, V) f32
        probability cache (dense), or the pair ``(mean_logits, lse)`` of the
        ``cache_dtype`` mean-logit cache and its (n_batches, B) f32
        normaliser (flash).  With ``out`` (a buffer tree of the cache's
        shapes) the cache is written there and ``out`` returned.  With
        ``weights`` ((M,) trust weights) the teachers' weighted logit sum
        takes the place of their mean: dense, kernel 2 over it as an M = 1
        stack."""
        if self.kd_kernel == "dense":
            if weights is None:
                cache = self.precompute_teacher_probs(teachers, batches)
            else:
                cache = kd_ops.ensemble_softmax_many(
                    self.precompute_weighted_logits(teachers, batches, weights)[None],
                    self.temperature)
        else:
            mean = (self.precompute_mean_logits(teachers, batches) if weights is None
                    else self.precompute_weighted_logits(teachers, batches, weights))
            data = mean.to(self.cache_dtype) if out is None else out[0].copy_(mean)
            del mean
            # τ-fixed and student-independent: computed once here, so every
            # step skips the teacher's max/sum chain
            cache = data, kd_ops.teacher_cache_lse(data, self.temperature)
        if out is None:
            return cache
        copy_into(out, cache)
        return out

    def cache_like(self, teachers: Sequence[PyTree], batches: PyTree):
        """The round's teacher cache as meta tensors, its shapes and dtypes
        alone: one teacher forward on the meta device gives the (B, V) row."""
        member = tree_map(lambda x: x.to("meta"), teachers[0])
        meta_batches = tree_map(lambda x: x.to("meta"), batches)
        with torch.no_grad():
            lg = self.logits_fn(tree_cast(member, torch.float32),
                                tree_map(lambda x: x[0], meta_batches))
        shape = (tree_leaves(batches)[0].shape[0],) + tuple(lg.shape)
        if self.kd_kernel == "dense":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        return (torch.empty(shape, dtype=self.cache_dtype, device="meta"),
                torch.empty(shape[:-1], dtype=torch.float32, device="meta"))

    def cache_nbytes(self, teachers: Sequence[PyTree], batches: PyTree) -> int:
        """Device bytes of the round's teacher cache, from shapes alone."""
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self.cache_like(teachers, batches)))

    def _cache(self, student: PyTree, teachers: Sequence[PyTree], batches: PyTree,
               weights=None):
        """The round's cache; under scan written into the KD step program's
        cache buffer, so that it is not held twice."""
        if self.steps and self.graphs.scan(self.device):
            prog = self._step_program(student, batches, self.cache_like(teachers, batches))
            return self.precompute_cache(teachers, batches, out=prog.buf["cache"],
                                         weights=weights)
        return self.precompute_cache(teachers, batches, weights=weights)

    # ------------------------------------------------- teacher trust weights
    @torch.no_grad()
    def trust_weights(self, teachers: Sequence[PyTree], server_batches: Sequence[Any],
                      degraded_mask=None) -> torch.Tensor:
        """(M,) per-teacher trust weights from cross-teacher agreement, on
        the device (no host sync).

        Each teacher's τ-softmax on the probe batch (the first server batch)
        is compared with the consensus, the coordinate-wise median over the
        teachers (an even M averages the two middle values, as
        ``jnp.median``): d_m = mean KL(p_m ‖ consensus), scaled by the median
        d, mapped through w = min(exp(1 − d/median(d)), 1), discounted ×
        ``TRUST_DEGRADED_DISCOUNT`` where ``degraded_mask`` marks a member,
        normalised, and cut to exactly 0 below ``TRUST_FLOOR`` × uniform,
        then normalised again.  The median needs M ≥ 3 to outvote a liar.
        """
        batches = self.batches_for(server_batches)
        probe = tree_map(lambda x: x[0], batches)
        lg = torch.stack([self.logits_fn(tree_cast(t, torch.float32), probe).float()
                          for t in teachers])                     # (M, B, V)
        p = torch.softmax(lg / self.temperature, dim=-1)
        cons = median(p)
        cons = cons / cons.sum(-1, keepdim=True).clamp_min(1e-12)
        eps = 1e-12
        kl = (p * (torch.log(p + eps) - torch.log(cons + eps))).sum(-1)  # (M, B)
        d = kl.mean(-1)
        m = d.shape[0]
        discount = torch.ones((m,), dtype=torch.float32)
        if degraded_mask is not None:
            mask = np.asarray(degraded_mask, bool)  # lint-ok: RA101 host mask
            discount = torch.from_numpy(
                np.where(mask, TRUST_DEGRADED_DISCOUNT, 1.0).astype(np.float32))
        w = torch.clamp(torch.exp(1.0 - d / (median(d) + 1e-12)), max=1.0) \
            * discount.to(d.device)
        uniform = torch.full_like(w, 1.0 / m)
        s = w.sum()
        w = torch.where(s > 0, w / s.clamp_min(1e-12), uniform)
        w = torch.where(w < TRUST_FLOOR / m, torch.zeros_like(w), w)
        s2 = w.sum()
        return torch.where(s2 > 0, w / s2.clamp_min(1e-12), uniform)

    # ------------------------------------------------------- KD step body
    def _loss_and_grad(self, student, batch, cache_row):
        # built at each call: an attribute holding a bound method would be a
        # cycle through the pipeline, which keeps its step programs' memory
        return value_and_grad(self._loss)(student, batch, cache_row)

    def _loss(self, student, batch, cache_row):
        tau = self.temperature
        if self.head_fused:
            zt, lse = cache_row
            w, b = self.head_fn(student)
            return kd_ops.flash_kd_head_loss(self.features_fn(student, batch), w, b, zt, tau,
                                             teacher_lse=lse)
        if self.kd_kernel == "flash":
            zt, lse = cache_row
            return kd_ops.flash_kd_loss(self.logits_fn(student, batch), zt, tau,
                                        teacher_lse=lse)
        return kd_ops.kd_loss(self.logits_fn(student, batch), cache_row, tau)

    def _run(self, student: PyTree, batches: PyTree, cache):
        """The whole schedule for one student; returns it and the (steps,)
        device tensor of losses.  ``cache`` is a tensor or a pair of
        tensors, each with the leading n_batches axis."""
        if self.steps == 0:
            return student, torch.zeros((0,), device=self.device)
        if self.graphs.scan(self.device):
            return self._run_scan(student, batches, cache)
        n = tree_leaves(cache)[0].shape[0]
        opt_state = self.optimizer.init(student)
        losses = []
        for s in range(self.steps):
            bi = s % n
            batch = tree_map(lambda x: x[bi], batches)
            loss, grads = self._loss_and_grad(student, batch, tree_map(lambda x: x[bi], cache))
            updates, opt_state = self.optimizer.update(grads, opt_state, student)
            student = apply_updates(student, updates)
            losses.append(loss)              # a device scalar: no sync here
        return student, torch.stack(losses)

    def _step_program(self, student, batches, cache):
        """The KD step program for these shapes (``cache`` may be meta
        tensors: its shapes are what count)."""
        key = (shape_key(student, batches, cache), self.steps)

        def build():
            dev = self.device
            n = tree_leaves(cache)[0].shape[0]
            buf = {"student": self.graphs.shared("model", student),
                   "opt": self.optimizer.init(student),      # fresh zeros: owned
                   "batches": static_like(batches), "cache": static_like(cache, device=dev),
                   "s": torch.zeros((1,), dtype=torch.int64, device=dev),
                   "losses": torch.zeros((self.steps,), dtype=torch.float32, device=dev)}

            me = weakref.proxy(self)    # the pipeline owns the program: no cycle through it

            def body():
                s = buf["s"]
                bi = torch.remainder(s, n)
                batch = tree_map(lambda x: x.index_select(0, bi)[0], buf["batches"])
                row = tree_map(lambda x: x.index_select(0, bi)[0], buf["cache"])
                loss, grads = me._loss_and_grad(buf["student"], batch, row)
                me.optimizer.update_(grads, buf["opt"], buf["student"])
                buf["losses"].index_copy_(0, s, loss.reshape(1).to(torch.float32))
                s.add_(1)

            return body, buf

        return self.graphs.program("kd/step", key, build)

    def _start_scan(self, student: PyTree, batches: PyTree, cache) -> StepProgram:
        """The KD step program with the schedule's inputs loaded: its next
        ``steps`` calls run the schedule."""
        prog = self._step_program(student, batches, cache)
        b = prog.buf
        copy_into(b["student"], student)
        torch._foreach_zero_(tree_leaves(b["opt"]))     # sgd's init: zero momentum
        copy_into(b["batches"], batches)
        copy_into(b["cache"], cache)
        b["s"].zero_()
        return prog

    @staticmethod
    def finish_steps(prog: StepProgram):
        """The distilled student and the (steps,) losses of a schedule the
        program ran, as copies."""
        b = prog.buf
        return tree_map(torch.clone, b["student"]), b["losses"].clone()

    def _run_scan(self, student: PyTree, batches: PyTree, cache):
        prog = self._start_scan(student, batches, cache)
        for _ in range(self.steps):
            prog()
        return self.finish_steps(prog)

    # ------------------------------------------------------------- public
    def distill(self, student: PyTree, teachers: Sequence[PyTree],
                server_batches: Sequence[Any], teacher_weights=None) -> tuple[PyTree, dict]:
        """Single-student KD (``distill_target='main'``).  ``teachers``: the
        list of member trees; ``teacher_weights``: optional (M,) trust
        weights."""
        batches = self.batches_for(server_batches)
        cache = self._cache(student, teachers, batches, teacher_weights)
        student, losses = self._run(student, batches, cache)
        return student, self._info(losses)

    def distill_all(self, students_stacked: PyTree, teachers: Sequence[PyTree],
                    server_batches: Sequence[Any],
                    teacher_weights=None) -> tuple[PyTree, dict]:
        """All K students over one cache (``distill_target='all'``); the
        reported losses are the main model's (row 0)."""
        batches = self.batches_for(server_batches)
        students = tree_unstack(students_stacked)
        cache = self._cache(students[0], teachers, batches, teacher_weights)
        outs, losses = zip(*(self._run(st, batches, cache) for st in students))
        return tree_stack(list(outs)), self._info(torch.stack(losses))

    # ------------------------------------------------------ overlapped KD
    def scan_capable(self) -> bool:
        """Whether the KD steps run as step programs on this device: the
        form the overlap executor pairs with the engine's bucket steps."""
        return self.graphs.scan(self.device)

    def lane(self):
        """The KD lane: a CUDA stream of the pipeline's own on a card, the
        label ``"kd"`` on the CPU."""
        if self._lane is None:
            self._lane = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                          else "kd")
        return self._lane

    def distill_async(self, student: PyTree, teachers: Sequence[PyTree],
                      server_batches: Sequence[Any], teacher_weights=None):
        """Issue the whole single-student KD phase on the KD lane and return
        the device tensors ``(student, losses)``: no host sync.  On a card
        the lane first waits for the caller's stream (the student and the
        ring are written there); the cache build, its kernel (2 or none) and
        the ``steps`` replays go onto the lane; then the step programs' set
        is held there until ``join``.  The student, the teachers, the
        weights and the server batches are marked in use on the lane."""
        dev, lane = self.device, self.lane()
        batches = self.batches_for(server_batches)
        if dev.type == "cuda":
            lane.wait_stream(torch.cuda.current_stream(dev))
            for x in tree_leaves((student, list(teachers), batches, teacher_weights)):
                x.record_stream(lane)
        with on_lane(lane, dev):
            out = self._run(student, batches,
                            self._cache(student, teachers, batches, teacher_weights))
        self.graphs.hold(lane, dev)
        return out

    def join(self, dispatched):
        """The caller's stream waits for the KD that ``distill_async`` issued
        (an event wait, no host sync) and takes over its outputs."""
        self.graphs.release(self.device)
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            for x in tree_leaves(dispatched):
                x.record_stream(cur)
        return dispatched

    def losses_info(self, losses: torch.Tensor) -> dict:
        """The per-round KD record of ``distill_async``'s losses: the one
        host pull, at resolve."""
        return self._info(losses)

    def start_steps(self, student: PyTree, teachers: Sequence[PyTree],
                    server_batches: Sequence[Any], teacher_weights=None) -> StepProgram:
        """Under scan: build the round's teacher cache into the KD step
        program and load the schedule's inputs; the program's next ``steps``
        calls (alone or paired) run the schedule, ``finish_steps`` reads it."""
        batches = self.batches_for(server_batches)
        cache = self._cache(student, teachers, batches, teacher_weights)
        return self._start_scan(student, batches, cache)

    def _info(self, losses: torch.Tensor) -> dict:
        """The per-round KD record: the one host pull of the phase."""
        with allowed_sync("one-per-round KD loss pull into the history record"):
            losses = losses.cpu().numpy()
        if losses.ndim == 2:                    # multi-student: main model
            losses = losses[0]
        return {"kd_loss_first": float(losses[0]) if losses.size else None,
                "kd_loss_last": float(losses[-1]) if losses.size else None,
                "kd_steps": self.steps}
