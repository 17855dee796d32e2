"""The model's blocks on DTensors: what each rank computes on its shards.

The dry run (``launch/dryrun.py``) runs the port's steps on DTensors over
the production mesh.  DTensor's propagation partitions the products,
norms and elementwise ops by itself; the blocks here are the ones it cannot
partition, or would partition by gathering whole tensors.  Each helper is
called only where its argument is a DTensor: on plain tensors the model's
code runs as it always did, so the card's path and its arithmetic are
unchanged.

``rows_only``
    the residual stream between blocks: its rows split, whole on every
    ``"model"`` rank.
``fsdp_gather``
    a block's FSDP-split weights gathered over ``"data"`` before use, as
    FSDP does (the gradients reduce-scatter back).
``column_blocks``
    a weight of concatenated projections re-split block by block.
``split_heads``
    a projection's heads, made whole first where they do not divide the
    ``"model"`` axis.
``merge_heads``
    the heads merged for the output projection, the gradient brought back
    whole over ``"model"`` before the backward splits it again.
``heads_local``
    attention and the recurrent scans per batch row and head or channel
    (``local_map``): each rank runs the plain function on its batch rows
    and, where the heads divide the ``"model"`` axis, its heads; else on a
    share of its rows, where they divide the axis; else on all of them.
``vocab_product``
    the LM head's product, split by vocab over ``"model"``.
``decode_local``
    one token's attention over the cache as it is placed: split-K over a
    sequence split, partial scores over a head-dim split.
``embed_rows``
    the embedding lookup on each rank's vocab shard.
``write_row``
    a decode's cache row written on the shard that holds its position.
``vocab_nll``
    the cross-entropy over vocab-sharded logits: a max and a sum that
    DTensor reduces over the shards, and the label's logit gathered on its
    shard, where ``logsumexp`` would all-gather the logits and ``gather``'s
    backward would build a zero tensor of the global shape.
``experts_local``
    a MoE layer's routed experts, expert-parallel over ``"model"``: each
    rank routes its tokens to every expert and runs the experts of its
    bank; the outputs sum over the axis (a ``Partial`` placement).  The
    router's aux loss of each rank is its tokens' (averaged over them).
"""
from __future__ import annotations

import functools
import math

import torch

TP_AXIS = "model"
ROWS = "rows"           # heads_local: an argument split only over its rows


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (checked without importing DTensor for a
    plain tensor)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _rows(x, mesh) -> list:
    """For each mesh dim, ``Shard(0)`` where ``x`` splits its leading
    (batch or token) dim over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if (pl.is_shard(0) and name != TP_AXIS) else Replicate()
            for name, pl in zip(mesh.mesh_dim_names, x.placements)]


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def _tp_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(TP_AXIS)) if TP_AXIS in names else 1


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward lays the gradient out densely."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense(fn, *args, **kwargs):
    """``fn`` on local shards, its tensor outputs and its inputs'
    gradients laid out densely: a DTensor takes its local tensor's layout
    for the global one's (``from_local``, and ``to_local``'s backward)."""
    args = tuple(_DenseGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                 else a for a in args)
    out = fn(*args, **kwargs)
    if isinstance(out, tuple):
        return tuple(o.contiguous() for o in out)
    return out.contiguous()


def rows_only(x):
    """``x`` split only over its rows (dim 0), whole on every ``"model"``
    rank: the residual stream between blocks, as a tensor-parallel layout
    keeps it (the products' own propagation would leave it split on the
    hidden dim, or as partial sums).  ``x`` itself where it is not a
    DTensor."""
    if not is_dtensor(x):
        return x
    return x.redistribute(placements=_rows(x, x.device_mesh))


def fsdp_gather(tree):
    """A block's weights whole over every axis but ``"model"``: the leaves
    that FSDP splits over ``"data"`` gathered before use (their gradients
    reduce-scattered back).  The tree itself where it holds no DTensor."""
    from repro_torch.utils.pytree import tree_map

    def one(x):
        if not is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate
        names = x.device_mesh.mesh_dim_names
        pl = [p if n == TP_AXIS else Replicate() for n, p in zip(names, x.placements)]
        return x if tuple(pl) == tuple(x.placements) else x.redistribute(placements=pl)

    return tree_map(one, tree)


def column_blocks(w, *widths):
    """The blocks of ``w``'s last dim of ``widths``, each split over
    ``"model"`` as ``w`` was: a weight whose columns concatenate two
    projections (Mamba's ``in_proj``) is gathered once and re-split by
    block, where slicing its shards would gather each product's output."""
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    full = w.redistribute(placements=[Replicate() if n == TP_AXIS else p
                                      for n, p in zip(names, w.placements)])
    starts = [sum(widths[:i]) for i in range(len(widths))]
    return [full[..., a:a + n].redistribute(placements=w.placements)
            for a, n in zip(starts, widths)]


def split_heads(x, *shape):
    """``x.reshape(*shape)``, splitting the last dim into heads.  A DTensor
    whose last dim is split over ``"model"`` into shards that do not
    divide the heads is made whole on every rank first."""
    if is_dtensor(x):
        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        if (TP_AXIS in names and x.placements[names.index(TP_AXIS)].is_shard(x.ndim - 1)
                and shape[x.ndim - 1] % mesh.size(names.index(TP_AXIS))):
            x = rows_only(x)
    return x.reshape(*shape)


class _RowsGrad(torch.autograd.Function):
    """The identity, whose backward gives the gradient ``rows_only``'s
    placement."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rows_only(g)


def merge_heads(x, *shape):
    """``x.reshape(*shape)``, merging the heads into the last dim.  On a
    DTensor the gradient comes back whole on every ``"model"`` rank: the
    backward splits the merged dim into heads again, which DTensor refuses
    (on some torch versions) where the output projection leaves the
    gradient split into shards that do not divide the heads."""
    y = x.reshape(*shape)
    return _RowsGrad.apply(y) if is_dtensor(y) else y


def heads_local(*dims, out=2, keep_heads: bool = False):
    """Decorator: run the function on each rank's batch rows and heads when
    one of its positional tensor arguments is a DTensor.

    ``dims[i]`` is the head dim of positional argument ``i`` (whose dim 0
    is its batch rows), ``ROWS`` for one split only over its rows,
    ``(None, d)`` for a weight with no rows whose dim ``d`` splits with the
    heads, or ``None`` for one every rank holds whole; arguments past
    ``dims`` are scalars or held whole.  ``out`` is the same for the
    output, or a tuple of them for a tuple of outputs.  The heads split
    over ``"model"`` where every argument's head count divides it (and not
    with ``keep_heads``); else the rows split further over ``"model"``
    where they divide it; else each ``"model"`` rank runs all of its
    rows."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not any(is_dtensor(a) for a in args):
                return fn(*args, **kwargs)
            from torch.distributed.tensor import Shard
            from torch.distributed.tensor.experimental import local_map
            first = next(a for a, d in zip(args, dims)
                         if d is not None and not isinstance(d, tuple) and is_dtensor(a))
            mesh = first.device_mesh
            # a plain tensor of the rows (a zero state the function made)
            # is the same on every rank
            args = tuple(_as_replicated(a, mesh)
                         if isinstance(a, torch.Tensor) and not is_dtensor(a)
                         and i < len(dims) and dims[i] is not None else a
                         for i, a in enumerate(args))
            rows = _rows(first, mesh)
            names = mesh.mesh_dim_names
            tp = names.index(TP_AXIS) if TP_AXIS in names else None
            heads = [(a, d if isinstance(d, int) else d[1])
                     for a, d in zip(args, dims) if isinstance(d, (int, tuple))]
            n = mesh.size(tp) if tp is not None else 1
            split = (n > 1 and not keep_heads
                     and all(a.shape[d] % n == 0 for a, d in heads))
            # else the rows, where each rank's rows split evenly over "model"
            held = math.prod(mesh.size(i) for i, r in enumerate(rows) if r.is_shard())
            by_rows = n > 1 and not split and first.shape[0] % (held * n) == 0

            def place(d):
                if isinstance(d, tuple):        # a weight split with the heads
                    pl = list(_replicated(mesh))
                    if split:
                        pl[tp] = Shard(d[1])
                    return pl
                if d is None:
                    return list(_replicated(mesh))
                pl = list(rows)
                if split and isinstance(d, int):
                    pl[tp] = Shard(d)
                elif by_rows:
                    pl[tp] = Shard(0)
                return pl

            in_pl = tuple(tuple(place(dims[i] if i < len(dims) else None))
                          if is_dtensor(a) else None for i, a in enumerate(args))
            out_pl = tuple(place(d) for d in out) if isinstance(out, tuple) else place(out)
            return local_map(functools.partial(_dense, fn), out_placements=out_pl,
                             in_placements=in_pl, device_mesh=mesh,
                             redistribute_inputs=True)(*args, **kwargs)

        return wrapped

    return deco


@heads_local(ROWS, (None, 1), out=2)
def vocab_product(x, head):
    """``x (B, S, D) @ head (D, V)`` on each rank's rows and vocab shard:
    the logits split over ``"model"`` by vocab, where DTensor's own choice
    may split the product's D instead and leave every rank the whole
    logits as partial sums."""
    return x @ head


def decode_local(fn):
    """Decorator for ``fn(q1, k_cache, v_cache, cache_len=None, *,
    window=0)``, one token's attention: on DTensors, each rank attends over
    its shard of the cache as the cache is placed.  Its batch rows and
    heads are the rank's own; a head dim split over a mesh dim sums the
    scores over it, and a sequence split over one combines the shards'
    softmax states (split-K: the max, then the rescaled sums and
    products), each an all-reduce over that dim."""

    @functools.wraps(fn)
    def wrapped(q1, k_cache, v_cache, cache_len=None, *, window: int = 0):
        if not is_dtensor(q1):
            return fn(q1, k_cache, v_cache, cache_len, window=window)
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = k_cache.device_mesh
        kv, q, seq, dh = [], [], [], []
        block = 0           # this rank's block of the sequence, outermost first
        for i, pl in enumerate(k_cache.placements):
            d = pl.dim if isinstance(pl, Shard) else None
            kv.append(Shard(d) if d is not None else Replicate())
            q.append(Replicate() if d in (None, 1) else Shard(d))
            if d == 1:
                seq.append(mesh.get_group(i))
                block = block * mesh.size(i) + mesh.get_local_rank(i)
            elif d == 3:
                dh.append(mesh.get_group(i))
        blocks = math.prod(mesh.size(i) for i, pl in enumerate(kv) if pl.is_shard(1))
        start = block * (k_cache.shape[1] // blocks)
        cl = _as_replicated(cache_len, mesh) if isinstance(cache_len, torch.Tensor) \
            and not is_dtensor(cache_len) else cache_len
        rep = _replicated(mesh) if is_dtensor(cl) else None
        body = functools.partial(_decode_shard, seq_start=start, seq_groups=seq,
                                 dh_groups=dh, window=window)
        out = local_map(body, out_placements=q, in_placements=(tuple(q), tuple(kv),
                                                               tuple(kv), rep),
                        device_mesh=mesh, redistribute_inputs=True)(q1, k_cache, v_cache, cl)
        # whole head dims, for the heads' merge into the output projection
        return out.redistribute(placements=[Replicate() if p.is_shard(3) else p for p in q])

    return wrapped


def write_row(cache, slot, row) -> None:
    """``cache[:, slot] = row[:, 0]`` in place on a DTensor cache (B, S,
    ...), on each rank's shard: the rank whose sequence block holds
    ``slot`` writes the row there; the others write back the row they
    hold.  (DTensor's own ``index_copy_`` may re-place the cache's spec
    without moving its shards.)"""
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    pl = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    row = (row if is_dtensor(row) else _as_replicated(row, mesh)).redistribute(placements=pl)
    local, row = cache.to_local(), row.to_local()
    n = local.shape[1]
    block = 0
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):
            block = block * mesh.size(i) + mesh.get_local_rank(i)
    slot = slot.to_local() if is_dtensor(slot) else slot
    at = slot.reshape(1).long() - block * n
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    local.index_copy_(1, at, torch.where(inside, row, local.index_select(1, at)))


def _all_reduce(x, op: str, groups):
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
    return x


def _decode_shard(q1, k, v, cache_len, *, seq_start: int, seq_groups, dh_groups,
                  window: int):
    """``decode_local``'s rank: q1 (B, 1, H, d) against its cache shard k,
    v (B, S_l, Hkv, d) holding positions from ``seq_start``."""
    from repro_torch.models.attention import NEG_INF, _scale
    B, _, H, d = q1.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = _scale(q1.reshape(B, Hkv, H // Hkv, d))
    scores = _all_reduce(torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()), "sum",
                         dh_groups)
    if cache_len is not None:
        cl = torch.as_tensor(cache_len, device=q1.device)
        cl = cl[:, None] if cl.ndim == 1 else cl.reshape(1, 1)
        pos = seq_start + torch.arange(S, device=q1.device)[None, :]
        valid = pos < cl
        if window > 0:
            valid &= pos >= cl - window
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
    m = _all_reduce(scores.amax(-1, keepdim=True), "max", seq_groups)
    p = torch.exp(scores - m)
    den = _all_reduce(p.sum(-1, keepdim=True), "sum", seq_groups)
    acc = _all_reduce(torch.einsum("bhgk,bkhd->bhgd", p, v.float()), "sum", seq_groups)
    return (acc / den).to(q1.dtype).reshape(B, 1, H, d)


def vocab_nll(logits, labels):
    """``logsumexp(logits) - logits[labels]`` over the last dim of f32
    DTensor logits, reduced over its shards: the max and the sum of the
    shifted exponentials as partial reductions, and the label's logit
    gathered on the shard that holds it (``_label_logit``), each summed
    whole on every rank of its rows.  The max is a constant of the
    backward, whose gradient is the softmax either way."""
    m = rows_only(logits.detach().amax(-1, keepdim=True))
    lse = rows_only((logits - m).exp().sum(-1, keepdim=True)).log() + m
    return (lse - rows_only(_label_logit(logits, labels)))[..., 0]


def _label_logit(logits, labels):
    """``logits[..., labels]`` (keeping the last dim), each rank gathering
    from its vocab shard the labels that fall in it (0 elsewhere; the
    shards' values sum to the logit): DTensor's own gather would build its
    backward in a zero tensor of the global shape."""
    lab = labels if is_dtensor(labels) else _as_replicated(labels, logits.device_mesh)
    return _vocab_local(_gather_shard, logits, logits.ndim - 1, lab)


def embed_rows(table, tokens):
    """``table[tokens]`` for a DTensor table (V, D) split over its vocab:
    each rank looks up the tokens its shard holds (0 for the others; the
    shards' rows sum to the embedding), where DTensor's indexing backward
    (``index_put``) has no sharding on some torch versions."""
    tok = tokens if is_dtensor(tokens) else _as_replicated(tokens, table.device_mesh)
    return _vocab_local(_lookup_shard, table, 0, tok)


def _vocab_local(body, x, vocab_dim: int, idx):
    """``body(x_shard, idx, start)`` on each rank: ``x`` split over
    ``"model"`` on ``vocab_dim`` where it is (the shard from vocab row
    ``start``), ``idx`` by its rows; the result split by ``idx``'s rows and
    summed over ``"model"`` where the vocab is split."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = _rows(idx, mesh)
    vocab, out = list(_replicated(mesh)), list(rows)
    start = 0
    if TP_AXIS in names and x.placements[names.index(TP_AXIS)].is_shard(vocab_dim):
        i = names.index(TP_AXIS)
        vocab[i], out[i] = Shard(vocab_dim), Partial()
        start = mesh.get_local_rank(TP_AXIS) * (x.shape[vocab_dim] // mesh.size(i))
    if vocab_dim:           # logits: their rows are the labels' rows
        vocab = [r if v == _replicated(mesh)[0] else v for r, v in zip(rows, vocab)]
    return local_map(body, out_placements=out,
                     in_placements=(tuple(vocab), tuple(rows), None), device_mesh=mesh,
                     redistribute_inputs=True)(x, idx, start)


def _gather_shard(logits, labels, start: int):
    """The local half of ``_label_logit``: a vocab shard from ``start``."""
    idx = labels.long()[..., None] - start
    inside = (idx >= 0) & (idx < logits.shape[-1])
    return torch.where(inside, logits.gather(-1, idx.clamp(0, logits.shape[-1] - 1)), 0.0)


def _lookup_shard(table, tokens, start: int):
    """The local half of ``embed_rows``: table rows from ``start``."""
    idx = tokens.long() - start
    inside = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))


def _as_replicated(x, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, _replicated(mesh), run_check=False)


def experts_local(routed, p, x, cfg, group_size: int):
    """``routed(p, x, cfg, group_size, expert0)`` -> (out, aux) on each
    rank's tokens (the rows of x ``(T, D)``) and expert bank (``p``'s
    ``w_in`` / ``w_gate`` / ``w_out``, split on the expert dim over
    ``"model"`` where it divides).  ``out`` of a rank holds its experts'
    share and sums over the axis; ``aux`` is the same on every rank of it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten
    mesh = x.device_mesh
    tp = _tp_size(mesh)
    E = cfg.moe.num_experts
    split = tp > 1 and E % tp == 0
    rows = _rows(x, mesh)
    bank, out = list(_replicated(mesh)), list(rows)
    if split:
        i = mesh.mesh_dim_names.index(TP_AXIS)
        bank[i], out[i] = Shard(0), Partial()
        expert0 = mesh.get_local_rank(TP_AXIS) * (E // tp)
    else:
        expert0 = 0
    args = (p, x, cfg, group_size, expert0)
    leaves, _ = tree_flatten(args)
    place = {id(p["router"]): _replicated(mesh), id(x): tuple(rows)}
    in_pl = tuple(place.get(id(a), tuple(bank)) if is_dtensor(a) else None for a in leaves)
    # each rank's aux is its tokens' (their mean over the row shards)
    aux = tuple(Partial("avg") if r.is_shard() else Replicate() for r in rows)
    return local_map(routed, out_placements=(out, list(aux)), in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)
