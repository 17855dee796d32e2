"""The client engines' shared planning and the vectorized client engine
(port of ``repro/core/engine.py``).

The sequential runner trains sampled clients one at a time.  The
vectorized engine stacks the clients of a bucket along a leading client
axis and trains them together: one step of the bucket is one
``torch.func.vmap`` of ``grad_and_value(loss_fn)`` over the stacked
params and the gathered minibatches, then the optimiser's elementwise
update on the stacked trees as they are (``_foreach`` ops over ``(C, ...)``
leaves), and ``tree_where`` to keep a client's params and optimiser state
frozen on its padded steps.  ``step_mode="stepped"`` drives one step per
Python iteration.  ``"scan"``, the reference's one program per bucket, makes
one bucket step a step program (``core/step_graph.py``): a CUDA graph on a
card, replayed S times, whose step index, gather and mask column live on the
device; on the CPU the same body runs eagerly.

``client_sharding="shard_map"`` (or ``"auto"`` over several ranks) splits
the client axis over the ranks of a ``launch.mesh`` client mesh, as the
reference's ``shard_map`` splits it over devices: ``prepare_bucket`` pads
the bucket to a multiple of the rank count by repeating row 0 with an
all-False step mask (exact no-ops) and keeps this rank's block of rows;
the bucket's program trains those rows; ``finish_bucket`` all-gathers
every rank's rows (params, optimiser state, losses) into the whole stack
on every rank and trims the padding.  The gather runs after the
program's steps, never inside a capture.  With one rank and no process
group the gather is the identity, so the run is ``"vmap"``'s bit for bit.

Exactness: ``build_round_entries`` draws the per-epoch permutations in
the order the sequential loop draws them (group-major, then epoch), so
both engines train on the same batches.  A client with fewer steps than
its bucket's maximum replays its step 0 on the padded steps, masked out.
Clients whose local batch size differs (a shard smaller than
``client_batch``) form their own bucket.  Bucket rows are in sorted-cid
order, so ``train_round`` permutes the results back into the round's
group-major order before Eq. 2 consumes them, even for a single bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import fedavg_aggregate_grouped
from repro_torch.core.client_store import InMemoryStore
from repro_torch.core.grouping import group_major_order
from repro_torch.core.step_graph import (StepGraphs, StepProgram, clone_tensors, copy_into,
                                         shape_key, static_like)
from repro_torch.device import to_device
from repro_torch.launch.mesh import all_gather_tree, mesh_size, use_shard_map
from repro_torch.optim.optimizers import Optimizer, advance_steps, apply_updates
from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_stack, tree_unstack,
                                      tree_where)

PyTree = Any


# =====================================================================
# round plan: host-side schedule, stacked device-side batches
# =====================================================================
@dataclass
class ClientPlan:
    """One batch-size bucket of the round's clients, stacked.

    ``data`` holds the bucket's full client shards on the device (leaves
    (Cb, n_pad, ...)); each step gathers its minibatches from it on the
    device with the (Cb, S, bs) ``indices``.  ``order`` gives each client's
    position in the round's group-major order.  ``num_steps`` is the host
    copy of ``step_mask.sum(1)``, so the engine knows without a device read
    which steps have a padded client.
    """
    cids: np.ndarray          # (Cb,) client ids (sorted)
    group_of: np.ndarray      # (Cb,) group index per client
    sizes: np.ndarray         # (Cb,) dataset sizes |X_i|
    order: np.ndarray         # (Cb,) position in the group-major round order
    batch_size: int
    data: PyTree              # leaves (Cb, n_pad, ...) on the device
    indices: torch.Tensor     # (Cb, S, bs) int32 rows into data, on the device
    step_mask: torch.Tensor   # (Cb, S) bool on the device: False rows are padded no-ops
    num_steps: np.ndarray     # (Cb,) real steps per client, on the host


@dataclass
class RoundPlan:
    groups: list[np.ndarray]
    plans: list[ClientPlan]
    num_clients: int          # total sampled this round (this plan's subset)


@dataclass
class ClientEntry:
    """One sampled client's fully-drawn local schedule (host side)."""
    pos: int                  # position in the group-major round order
    cid: int
    group: int
    n: int                    # dataset size |X_i|
    bs: int                   # local batch size min(client_batch, n)
    idx: np.ndarray           # (S_c, bs) int32 minibatch index rows
    # fault injection (core/faults.py): a dropped client keeps a 1-step
    # schedule, so bucket shapes stay those of a clean round, but weighs
    # zero in Eq. 2 and never commits its controls
    dropped: bool = False


def _store_for(task, store):
    """``None`` plans through an ephemeral in-memory store (no caching
    across calls)."""
    return InMemoryStore(task) if store is None else store


def build_round_entries(task, cfg, groups: Sequence[np.ndarray],
                        rng: np.random.Generator, store=None) -> list[ClientEntry]:
    """Draw every sampled client's epoch schedule, in the exact order the
    sequential runner draws it (for k in groups: for cid in group: for
    epoch: ...)."""
    store = _store_for(task, store)
    entries: list[ClientEntry] = []
    cids, gids = group_major_order(groups)
    for pos, (cid, k) in enumerate(zip(cids, gids)):
        n = store.num_examples(int(cid))
        bs = min(cfg.client_batch, n)
        steps = []
        for _ in range(cfg.local_epochs):
            perm = rng.permutation(n)
            for i in range(0, n - bs + 1, bs):
                steps.append(perm[i:i + bs])
        entries.append(ClientEntry(
            pos=pos, cid=int(cid), group=int(k), n=n, bs=bs,
            idx=np.asarray(steps, np.int32)))  # lint-ok: RA101 host rng schedule
    return entries


def entry_pad_hints(entries: Sequence[ClientEntry]) -> dict[int, tuple]:
    """Per-batch-size (S, n_pad) maxima over a whole round's entries: the
    pad targets of the round's buckets.  Taken before the round's faults
    truncate schedules, so a degraded round pads back up to a clean one's
    shapes and replays its step programs."""
    hints: dict[int, tuple] = {}
    for e in entries:
        s, n = hints.get(e.bs, (0, 0))
        hints[e.bs] = (max(s, len(e.idx)), max(n, e.n))
    return hints


def plans_from_entries(task, entries: Sequence[ClientEntry], store=None,
                       pad_to: Optional[dict] = None) -> list[ClientPlan]:
    """Bucket pre-drawn entries by batch size and stack them.  Shards come
    off the store's device tier."""
    store = _store_for(task, store)
    plans: list[ClientPlan] = []
    for bs in sorted({e.bs for e in entries}):
        # sorted-cid bucket order -> a round-stable cache key
        sub = sorted((e for e in entries if e.bs == bs), key=lambda e: e.cid)
        S = max(len(e.idx) for e in sub)
        n_pad = max(e.n for e in sub)
        if pad_to and bs in pad_to:
            S, n_pad = max(S, pad_to[bs][0]), max(n_pad, pad_to[bs][1])
        idxs, masks = [], []
        for e in sub:
            idx, s_c = e.idx, len(e.idx)
            if s_c < S:  # pad with replays of step 0; masked out below
                idx = np.concatenate([idx, np.tile(idx[:1], (S - s_c, 1))])
            idxs.append(idx)
            masks.append(np.arange(S) < s_c)
        data = store.get_bucket([e.cid for e in sub], n_pad)
        dev = tree_leaves(data)[0].device
        plans.append(ClientPlan(
            cids=np.asarray([e.cid for e in sub]),
            group_of=np.asarray([e.group for e in sub]),
            sizes=np.asarray([e.n for e in sub]),
            order=np.asarray([e.pos for e in sub]),
            batch_size=bs,
            data=data,
            indices=to_device(np.stack(idxs), dev),
            step_mask=to_device(np.stack(masks), dev),
            num_steps=np.asarray([len(e.idx) for e in sub]),
        ))
    return plans


def plan_from_entries(task, entries: Sequence[ClientEntry],
                      groups: Sequence[np.ndarray], store=None,
                      pad_to: Optional[dict] = None) -> RoundPlan:
    """RoundPlan over an entry subset."""
    return RoundPlan(groups=list(groups),
                     plans=plans_from_entries(task, entries, store, pad_to),
                     num_clients=len(entries))


def build_round_plan(task, cfg, groups: Sequence[np.ndarray],
                     rng: np.random.Generator, store=None) -> RoundPlan:
    """Materialise every sampled client's epoch schedule, stacked."""
    store = _store_for(task, store)
    entries = build_round_entries(task, cfg, groups, rng, store)
    return plan_from_entries(task, entries, groups, store)


# =====================================================================
# engine
# =====================================================================
def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class VectorizedClientEngine:
    """Trains every client of a bucket as one stacked program.

    ``loss_fn``/``optimizer`` are the objects the sequential oracle uses,
    so the per-step arithmetic is the same; only the execution differs.
    ``graphs`` holds the scan mode's step programs (the runner's, so its
    programs share one graph memory pool); the engine asks it under its own
    ``step_mode``, whose ``"auto"`` is ``"stepped"`` off a card.  ``mesh``
    (``launch.mesh.make_client_mesh``) and ``client_sharding`` decide
    whether the client axis is split over ranks (``launch.mesh.use_shard_map``).
    """

    def __init__(self, loss_fn: Callable, optimizer: Optimizer, mesh=None,
                 client_sharding: str = "auto", step_mode: str = "auto",
                 graphs: Optional[StepGraphs] = None):
        if client_sharding not in ("auto", "vmap", "shard_map"):
            raise ValueError(f"client_sharding={client_sharding!r} not in "
                             "('auto', 'vmap', 'shard_map')")
        self.mesh = mesh
        self.client_sharding = client_sharding
        self.graphs = (graphs.with_mode(step_mode, "stepped") if graphs is not None
                       else StepGraphs(step_mode, "stepped"))
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._grad_fn = None
        self._buckets: dict = {}      # static key -> the bucket program of largest capacity

    def jit_programs(self) -> dict:
        """The engine's bucket step programs by label (see
        ``analysis.TraceGuard``)."""
        return self.graphs.jit_programs("engine/")

    def vmapped_grad(self) -> Callable:
        """``(stacked params, stacked batch) -> (grads, (loss, aux))``, each
        with the leading client axis: ``vmap(grad_and_value(loss_fn))``."""
        if self._grad_fn is None:
            self._grad_fn = torch.func.vmap(
                torch.func.grad_and_value(self.loss_fn, has_aux=True))
        return self._grad_fn

    def step(self, params: PyTree, opt_state: PyTree, data: PyTree,
             indices: torch.Tensor, mask: torch.Tensor, si: int, padded: bool):
        """Step ``si`` of every client of a bucket.  The minibatches are
        gathered on the device in one indexing op per data leaf; with
        ``padded`` (some client has no step ``si``) the masked clients keep
        their params and optimiser state."""
        idx = indices[:, si]
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        batch = tree_map(lambda x: x[rows, idx], data)
        grads, (loss, _) = self.vmapped_grad()(params, batch)
        updates, new_state = self.optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        if padded:
            m = mask[:, si]
            new_params = tree_where(m, new_params, params)
            new_state = tree_where(m, new_state, opt_state)
        return new_params, new_state, loss

    # ---- bucket execution ----------------------------------------------
    def _use_shard_map(self) -> bool:
        return use_shard_map(self.mesh, self.client_sharding)

    def prepare_bucket(self, plan: ClientPlan, stacked_params: PyTree,
                       stacked_opt_state: PyTree) -> tuple:
        """A bucket's args for ``run_prepared``, and its true client count C
        for ``finish_bucket``.  Sharded over n ranks: the bucket padded to a
        multiple of n by repeating row 0 with an all-False step mask (exact
        no-ops), and of that this rank's block of rows."""
        C = len(plan.cids)
        args = (stacked_params, stacked_opt_state, plan.data, plan.indices,
                plan.step_mask, plan.num_steps)
        n = mesh_size(self.mesh) if self._use_shard_map() else 1
        if n == 1:
            return args, C
        rows = -(-C // n)
        lo = self.mesh.rank * rows
        real = np.arange(lo, lo + rows) < C
        idx = np.where(real, np.arange(lo, lo + rows), 0)    # padded rows: row 0's

        def take(x):
            return x[lo:lo + rows] if real.all() else x.index_select(0, keep)

        keep = None if real.all() else to_device(idx, plan.indices.device)
        p, s, data, indices, mask = _stacked_map(take, args[:5])
        if not real.all():
            mask = mask & to_device(real, mask.device)[:, None]
        num_steps = np.where(real, plan.num_steps[idx], 0)
        return (p, s, data, indices, mask, num_steps), C

    def finish_bucket(self, out, C: int):
        """``run_prepared``'s outputs as the whole bucket's stacks: sharded,
        every rank's rows gathered in rank order and the padding trimmed."""
        if not self._use_shard_map():
            return out
        p, s, losses = all_gather_tree(out, self.mesh)
        if losses.shape[0] != C:
            p, s, losses = _stacked_map(lambda x: x[:C], (p, s, losses))
        return p, s, losses

    def run_prepared(self, args):
        """Every step of one bucket; returns the trained params, optimiser
        state and the (C, S) losses."""
        p, s, data, indices, mask, num_steps = args
        if self.graphs.scan(indices.device):
            return self._run_scan(args)
        losses = []
        for si in range(mask.shape[1]):
            p, s, loss = self.step(p, s, data, indices, mask, si,
                                   padded=bool((num_steps <= si).any()))
            losses.append(loss)
        return p, s, torch.stack(losses, dim=1)

    def _bucket_program(self, p, s, data, indices, mask):
        """The bucket step program for these inputs.  Its buffers hold S
        steps and n examples a client up to a capacity, a power of two that
        only grows, so rounds whose S and n_pad differ replay one graph."""
        S = mask.shape[1]
        n = tree_leaves(data)[0].shape[1]
        base = (shape_key(p, s, tree_map(lambda x: x[:, 0], data)), indices.shape[2])
        old = self._buckets.get(base)
        cap = old.buf["capacity"] if old is not None else (0, 0)
        if S > cap[0] or n > cap[1]:
            cap = (max(cap[0], _pow2(S)), max(cap[1], _pow2(n)))
            if old is not None:
                self.graphs.drop(old)
        prog = self._buckets[base] = self.graphs.program(
            "engine/bucket", base + cap,
            lambda: self._build_bucket(p, s, data, indices, cap))
        return prog

    def _build_bucket(self, p, s, data, indices, cap):
        S_cap, n_cap = cap
        C, _, bs = indices.shape
        dev = indices.device
        buf = {"capacity": cap, "params": static_like(p), "opt": static_like(s),
               "data": static_like(data, lambda x: (C, n_cap) + tuple(x.shape[2:])),
               "indices": torch.zeros((C, S_cap, bs), dtype=indices.dtype, device=dev),
               "mask": torch.zeros((C, S_cap), dtype=torch.bool, device=dev),
               "losses": torch.zeros((C, S_cap), dtype=torch.float32, device=dev),
               "si": torch.zeros((1,), dtype=torch.int64, device=dev),
               "rows": torch.arange(C, device=dev)[:, None]}

        grad_fn, optimizer = self.vmapped_grad(), self.optimizer   # no cycle through self

        def body():
            # step si of every client: its index row and mask column read on
            # the device; the mask always applied (True keeps the new tensors
            # exactly), the params and state written back in place
            si = buf["si"]
            idx = buf["indices"].index_select(1, si)[:, 0]
            m = buf["mask"].index_select(1, si)[:, 0]
            batch = tree_map(lambda x: x[buf["rows"], idx], buf["data"])
            params, state = buf["params"], buf["opt"]
            grads, (loss, _) = grad_fn(params, batch)
            updates, new_state = optimizer.update(grads, state, params)
            copy_into(params, tree_where(m, apply_updates(params, updates), params))
            copy_into(state, tree_where(m, new_state, state))
            buf["losses"].index_copy_(1, si, loss[:, None].to(torch.float32))
            si.add_(1)

        return body, buf

    def start_prepared(self, args) -> tuple[StepProgram, int]:
        """Under scan: the bucket step program with a prepared bucket's inputs
        loaded, and its step count S; the program's next S calls (alone or
        paired) train the bucket, ``finish_prepared`` reads it."""
        p, s, data, indices, mask, _ = args
        prog = self._bucket_program(p, s, data, indices, mask)
        b = prog.buf
        copy_into(b["params"], p)
        copy_into(b["opt"], s)
        copy_into(b["data"], data)
        copy_into(b["indices"], indices)
        copy_into(b["mask"], mask)
        b["si"].zero_()
        return prog, mask.shape[1]

    @staticmethod
    def finish_prepared(prog: StepProgram, args):
        """The trained stacks of a bucket ``start_prepared`` loaded, as copies;
        a host counter of the state (SCAFFOLD's steps) is the input's
        advanced by S, as stepped gives."""
        s, S = args[1], args[4].shape[1]
        b = prog.buf
        state = tree_map(lambda x, y: x.clone() if isinstance(x, torch.Tensor) else y,
                         b["opt"], s)
        return clone_tensors(b["params"]), advance_steps(state, S), b["losses"][:, :S].clone()

    def _run_scan(self, args):
        prog, S = self.start_prepared(args)
        for _ in range(S):
            prog()
        return self.finish_prepared(prog, args)

    def train_bucket(self, plan: ClientPlan, stacked_params: PyTree,
                     stacked_opt_state: PyTree):
        """(Cb, ...)-stacked params and optimiser state -> trained stacks."""
        args, C = self.prepare_bucket(plan, stacked_params, stacked_opt_state)
        return self.finish_bucket(self.run_prepared(args), C)

    def train_round(self, rplan: RoundPlan, init_params_for: Callable,
                    init_opt_state_for: Callable, run_buckets: Optional[Callable] = None):
        """Train every bucket; return the client stacks in the plan's
        group-major client order.

        ``init_params_for(plan) -> (Cb, ...) start params``;
        ``init_opt_state_for(plan, stacked_params) -> stacked opt state``.
        ``run_buckets``, when given, replaces the per-bucket dispatch: it takes
        the list of prepared args (``prepare_bucket``) and returns their
        outputs, as ``run_prepared`` would (the overlap executor's paired
        programs).  ``finish_bucket`` then gathers each bucket's rows.

        Returns ``(stacked_params, group_ids, sizes, buckets)``: leaves (C,
        ...) in group-major client order, and per bucket ``(plan,
        trained_params, final_opt_state, start_params)`` (SCAFFOLD's control
        update needs the bucket view).
        """
        prepared = []
        for plan in rplan.plans:
            w0 = init_params_for(plan)
            prepared.append((plan, w0, *self.prepare_bucket(plan, w0, init_opt_state_for(plan, w0))))
        if run_buckets is None:
            outs = [self.run_prepared(args) for _, _, args, _ in prepared]
        else:
            outs = run_buckets([args for _, _, args, _ in prepared])
        # every bucket's collective after all of them ran: never inside a
        # capture, nor between the paired programs of overlap="fused"
        outs = [self.finish_bucket(out, C) for (*_, C), out in zip(prepared, outs)]
        buckets = [(plan, p, s, w0) for (plan, w0, _, _), (p, s, _) in zip(prepared, outs)]
        # bucket rows are in sorted-cid order, not round order: the
        # permutation is needed even for a single bucket
        inv = np.argsort(np.concatenate([b[0].order for b in buckets]))
        dev = tree_leaves(buckets[0][1])[0].device
        perm = to_device(inv, dev)
        stacked = tree_map(lambda *xs: torch.cat(xs)[perm], *[b[1] for b in buckets])
        group_ids = np.concatenate([b[0].group_of for b in buckets])[inv]
        sizes = np.concatenate([b[0].sizes for b in buckets])[inv]
        return stacked, group_ids, sizes, buckets


def _stacked_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the stacked leaves of a tree (tensors with a leading
    client axis); 0-d tensors and host values pass through."""
    return tree_map(lambda x: fn(x) if isinstance(x, torch.Tensor) and x.ndim >= 1 else x,
                    tree)


def aggregate_groups(stacked_params: PyTree, sizes, group_ids,
                     num_groups: int) -> PyTree:
    """Eq. 2 for every group at once over the client axis (the mean of a
    round with no faults and no robust statistic)."""
    return fedavg_aggregate_grouped(stacked_params, sizes, group_ids, num_groups)


def stack_models(models: Sequence[PyTree]) -> PyTree:
    return tree_stack(list(models))


def unstack_models(stacked: PyTree) -> list[PyTree]:
    return tree_unstack(stacked)
