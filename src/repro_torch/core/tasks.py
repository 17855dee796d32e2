"""Ready-made FedTasks (port of ``repro/core/tasks.py``): the paper's
image-classification setting on the synthetic CIFAR stand-in, with the
paper's ResNets, a small CNN or a tiny MLP (``classification_task``), a
task sized by client count whose shards exist only while a round holds
them (``synthetic_scaling_task``, over ``LazyClientData``), and FedSDD
over a model-zoo LM on synthetic token shards (``lm_task``).

Data stays NHWC as in the reference (the MLP flattens it in that order).
The numpy arrays are the reference's, byte for byte.  The server batches
and the test set go to the device once; ``make_batch`` moves one client
minibatch per step, as the reference does, from pinned memory without a
host sync on a GPU.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.configs.resnet_cifar import get_resnet_config
from repro_torch.core.fedsdd import FedTask
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import SyntheticClassification, make_model_batch
from repro_torch.models.model_zoo import build_model
from repro_torch.models.resnet import conv, init_resnet, resnet_accuracy, resnet_logits, resnet_loss


# ---------------------------------------------------------------- small CNN
def _init_cnn(gen: torch.Generator, num_classes: int = 10, width: int = 16):
    r = partial(torch.randn, generator=gen, device=gen.device)
    return {
        "c1": r((3, 3, 3, width)) * 0.2,
        "c2": r((3, 3, width, width * 2)) * 0.1,
        "w": r((width * 2, num_classes)) * 0.1,
        "b": torch.zeros((num_classes,), device=gen.device),
    }


def _cnn_logits(params, x):
    h = F.relu(conv(x, params["c1"], 2))
    h = F.relu(conv(h, params["c2"], 2))
    h = h.mean(dim=(1, 2))
    return h @ params["w"] + params["b"]


# ---------------------------------------------------------------- tiny MLP
def _init_mlp(gen: torch.Generator, num_classes: int = 10, width: int = 32):
    d_in = 32 * 32 * 3
    r = partial(torch.randn, generator=gen, device=gen.device)
    return {
        "w1": r((d_in, width)) * float(1.0 / np.sqrt(d_in)),
        "b1": torch.zeros((width,), device=gen.device),
        "w2": r((width, num_classes)) * 0.1,
        "b2": torch.zeros((num_classes,), device=gen.device),
    }


def _mlp_logits(params, x):
    h = x.reshape(x.shape[0], -1) @ params["w1"] + params["b1"]
    return F.relu(h) @ params["w2"] + params["b2"]


def _xent(logits, y):
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()


# ------------------------------------------------------- lazy client data
class LazyClientData:
    """A sequence of client shards made on first touch, for C = 1M clients
    with nothing made up front: ``len()`` and each client's size are known
    beforehand (``num_examples``, the store's size probe), and a small LRU
    keeps the shards a round touches.  ``make_shard(cid, n)`` depends on
    ``cid`` alone, so a shard made again after an eviction or a restart is
    the same (numpy arrays, the reference's bytes)."""

    def __init__(self, num_clients: int, examples_per_client: int, make_shard,
                 cache_size: int = 16):
        self._num_clients = int(num_clients)
        self._n = int(examples_per_client)
        self._make_shard = make_shard
        self._cache_size = int(cache_size)
        self._cache: dict[int, object] = {}     # insertion-ordered LRU

    def __len__(self) -> int:
        return self._num_clients

    def num_examples(self, cid: int) -> int:
        return self._n

    def __getitem__(self, cid: int):
        cid = int(cid)
        if not 0 <= cid < self._num_clients:
            raise IndexError(cid)
        if cid in self._cache:
            self._cache[cid] = self._cache.pop(cid)   # refresh recency
            return self._cache[cid]
        shard = self._make_shard(cid, self._n)
        self._cache[cid] = shard
        while len(self._cache) > self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        return shard

    def __iter__(self):
        return (self[c] for c in range(self._num_clients))


# ---------------------------------------------------------------- tasks
def classification_task(model: str = "cnn",
                        num_clients: int = 20,
                        alpha: float = 0.1,
                        num_classes: int = 10,
                        num_train: int = 4000,
                        num_server: int = 1024,
                        server_batch: int = 256,
                        noise: float = 0.6,
                        seed: int = 0,
                        device=None) -> FedTask:
    """The paper's CIFAR setting on the synthetic stand-in, on ``device``
    (``cuda`` unless the caller passes ``"cpu"``).

    model: "cnn" (fast) | "mlp" (tiny) | "resnet20" | "resnet56" | "wrn16-2"
           (the paper's).
    """
    dev = device_lib.resolve(device)
    data = SyntheticClassification(num_classes=num_classes, num_train=num_train,
                                   num_server=num_server, noise=noise, seed=seed)
    x_tr, y_tr = data.train()
    x_te, y_te = data.test()
    parts = dirichlet_partition(y_tr, num_clients, alpha, seed=seed + 17)
    client_data = [(x_tr[ix], y_tr[ix]) for ix in parts]
    sx = data.server_unlabeled()
    server_batches = [
        {"x": torch.from_numpy(sx[i:i + server_batch]).to(dev)}
        for i in range(0, len(sx) - server_batch + 1, server_batch)
    ]
    x_te_d = torch.from_numpy(x_te).to(dev)
    y_te_d = torch.from_numpy(y_te).to(dev)

    if model in ("cnn", "mlp"):
        net = _cnn_logits if model == "cnn" else _mlp_logits
        init_fn = partial(_init_cnn if model == "cnn" else _init_mlp,
                          num_classes=num_classes)
        logits_fn = lambda p, b: net(p, b["x"])
        loss_fn = lambda p, b: (_xent(net(p, b["x"]), b["y"]), {})

        @torch.no_grad()
        def eval_fn(p):
            hits = torch.zeros((), dtype=torch.int64, device=dev)
            for i in range(0, len(x_te_d), 500):
                hits += (net(p, x_te_d[i:i + 500]).argmax(-1) == y_te_d[i:i + 500]).sum()
            return int(hits) / len(x_te_d)
    else:
        rcfg = get_resnet_config(model, num_classes)
        init_fn = lambda gen: init_resnet(gen, rcfg)
        logits_fn = lambda p, b: resnet_logits(p, b["x"], rcfg)
        loss_fn = lambda p, b: resnet_loss(p, b, rcfg)
        eval_fn = lambda p: resnet_accuracy(p, x_te_d, y_te_d, rcfg)

    def make_batch(ds, idx):
        x, y = ds
        return {"x": device_lib.to_device(x[idx], dev), "y": device_lib.to_device(y[idx], dev)}

    return FedTask(init_fn=init_fn, loss_fn=loss_fn, logits_fn=logits_fn,
                   client_data=client_data, server_batches=server_batches,
                   make_batch=make_batch, eval_fn=eval_fn, device=dev)


def synthetic_scaling_task(num_clients: int, examples_per_client: int = 64,
                           num_classes: int = 10, num_server: int = 256,
                           server_batch: int = 128, noise: float = 0.6, seed: int = 0,
                           device=None) -> FedTask:
    """A classification task sized by client count, not data volume:
    ``client_data`` is a ``LazyClientData`` over per-cid shards
    (``SyntheticClassification.client_shard``), so the task at C = 1M holds
    nothing until a round samples a client.  The tiny MLP; no eval set."""
    dev = device_lib.resolve(device)
    data = SyntheticClassification(num_classes=num_classes, num_train=0, num_test=0,
                                   num_server=num_server, noise=noise, seed=seed)
    client_data = LazyClientData(num_clients, examples_per_client, data.client_shard)
    sx = data.server_unlabeled()
    server_batches = [
        {"x": torch.from_numpy(sx[i:i + server_batch]).to(dev)}
        for i in range(0, len(sx) - server_batch + 1, server_batch)
    ]
    init_fn = partial(_init_mlp, num_classes=num_classes)

    def make_batch(ds, idx):
        x, y = ds
        return {"x": device_lib.to_device(x[idx], dev), "y": device_lib.to_device(y[idx], dev)}

    return FedTask(init_fn=init_fn,
                   loss_fn=lambda p, b: (_xent(_mlp_logits(p, b["x"]), b["y"]), {}),
                   logits_fn=lambda p, b: _mlp_logits(p, b["x"]), client_data=client_data,
                   server_batches=server_batches, make_batch=make_batch, eval_fn=None,
                   device=dev)


def lm_task(cfg, num_clients: int = 8, docs_per_client: int = 8, seq: int = 32,
            server_batches_n: int = 2, server_batch: int = 4, seed: int = 0,
            device=None) -> FedTask:
    """FedSDD over a model-zoo architecture: clients hold token shards, the
    server distils on unlabeled token batches; the KD logits are flattened
    over sequence positions, (B·S, V).  The shards are the reference's
    numpy arrays byte for byte (seeds ``seed*991 + c`` and
    ``seed*7919 + 100 + i``).  ``features_fn`` and ``head_fn`` split
    ``logits_fn`` for the head-fused Flash-KD path:
    ``logits_fn(p, b) == features_fn(p, b) @ head_fn(p)[0]``.  On a MoE
    model the client loss carries the router's aux term (``Model.loss``);
    the KD path reads the logits or features, as for a dense model."""
    dev = device_lib.resolve(device)
    model = build_model(cfg)

    def loss_fn(p, b):
        return model.loss(p, b)

    def logits_fn(p, b):
        lg, _ = model.logits(p, b)
        return lg.reshape(-1, cfg.vocab_size)

    def features_fn(p, b):
        return model.features(p, b).reshape(-1, cfg.d_model)

    def head_fn(p):
        return model.head(p), None          # zoo heads carry no bias

    client_data = [make_model_batch(cfg, docs_per_client, seq, seed=seed * 991 + c)
                   for c in range(num_clients)]
    server_batches = []
    for i in range(server_batches_n):
        b = make_model_batch(cfg, server_batch, seq, seed=seed * 7919 + 100 + i)
        server_batches.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})

    def make_batch(ds, idx):
        return {k: device_lib.to_device(v[np.asarray(idx)], dev) for k, v in ds.items()}

    return FedTask(init_fn=model.init_from, loss_fn=loss_fn, logits_fn=logits_fn,
                   client_data=client_data, server_batches=server_batches,
                   make_batch=make_batch, eval_fn=None, device=dev,
                   features_fn=features_fn, head_fn=head_fn)
