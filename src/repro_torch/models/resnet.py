"""CIFAR-style ResNets (ResNet-20/56, WRN16-2), the paper's own models
(port of ``repro/models/resnet.py``).

Plain functions on the reference's parameter tree: HWIO kernels, NHWC
activations at every public function.  At each convolution the NHWC
tensor is viewed as NCHW (``permute``, no copy: it is then a
channels-last NCHW tensor, the layout cuDNN prefers on Hopper) and the
kernel as OIHW.

Padding is XLA's ``"SAME"``: ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
split with the smaller half *before*.  For a 3×3 kernel at stride 2 on an
even input that is 0 before and 1 after, which torch's symmetric
``padding=1`` would get wrong, so uneven pads go through ``F.pad``.

Normalisation is GroupNorm by default, ``gcd(8, C)`` groups of contiguous
channels, population variance, eps 1e-5 — what ``F.group_norm`` computes;
``norm="batch"`` uses training-mode batch statistics.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.resnet_cifar import ResNetConfig


def _conv_init(gen: torch.Generator, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device)
    return w * float(np.sqrt(2.0 / fan_in))


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1):
    """x (B,H,W,Cin) NHWC × w (kh,kw,Cin,Cout) HWIO -> NHWC, "SAME"."""
    kh, kw = w.shape[:2]
    (pt, pb), (pl, pr) = (_same_pad(x.shape[1], kh, stride),
                          _same_pad(x.shape[2], kw, stride))
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, wc, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def _norm_params(c: int, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def apply_norm(p, x, cfg: ResNetConfig):
    """x (B,H,W,C) NHWC."""
    if cfg.norm == "batch":
        mu = x.mean(dim=(0, 1, 2), keepdim=True)
        var = x.var(dim=(0, 1, 2), correction=0, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    C = x.shape[-1]
    y = F.group_norm(x.permute(0, 3, 1, 2), math.gcd(8, C), p["scale"], p["bias"], 1e-5)
    return y.permute(0, 2, 3, 1)


def _init_block(gen, cin, cout, stride):
    p = {
        "conv1": _conv_init(gen, 3, 3, cin, cout),
        "n1": _norm_params(cout, gen.device),
        "conv2": _conv_init(gen, 3, 3, cout, cout),
        "n2": _norm_params(cout, gen.device),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
    return p


def _apply_block(p, x, cfg, stride):
    h = F.relu(apply_norm(p["n1"], conv(x, p["conv1"], stride), cfg))
    h = apply_norm(p["n2"], conv(h, p["conv2"]), cfg)
    sc = conv(x, p["proj"], stride) if "proj" in p else x
    return F.relu(h + sc)


def init_resnet(gen: torch.Generator, cfg: ResNetConfig):
    """The reference's tree (same keys, shapes, dtypes) with He-normal
    convolutions drawn from ``gen`` on ``gen.device``; the numbers differ
    from ``jax.random``'s by design (the tests carry JAX's weights across)."""
    n = cfg.num_blocks_per_stage
    widths = [16 * cfg.width_mult, 32 * cfg.width_mult, 64 * cfg.width_mult]
    params = {"stem": _conv_init(gen, 3, 3, 3, 16),
              "stem_n": _norm_params(16, gen.device)}
    cin = 16
    for s, w in enumerate(widths):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            params[f"s{s}b{b}"] = _init_block(gen, cin, w, stride)
            cin = w
    head_w = torch.randn((cin, cfg.num_classes), generator=gen, device=gen.device)
    params["head"] = {"w": head_w / float(np.sqrt(cin)),
                      "b": torch.zeros((cfg.num_classes,), device=gen.device)}
    return params


def resnet_logits(params, x, cfg: ResNetConfig):
    """x: (B, 32, 32, 3) f32 NHWC -> logits (B, num_classes)."""
    n = cfg.num_blocks_per_stage
    h = F.relu(apply_norm(params["stem_n"], conv(x, params["stem"]), cfg))
    for s in range(3):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            h = _apply_block(params[f"s{s}b{b}"], h, cfg, stride)
    h = h.mean(dim=(1, 2))
    return h @ params["head"]["w"] + params["head"]["b"]


def resnet_loss(params, batch, cfg: ResNetConfig):
    logits = resnet_logits(params, batch["x"], cfg)
    labels = batch["y"].long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc.detach()}


@torch.no_grad()
def resnet_accuracy(params, x, y, cfg: ResNetConfig, batch: int = 500) -> float:
    """Full-set accuracy of tensors ``x`` (N,32,32,3), ``y`` (N,) evaluated
    in minibatches on their device; one host sync at the end."""
    hits = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, len(x), batch):
        logits = resnet_logits(params, x[i:i + batch], cfg)
        hits += (logits.argmax(-1) == y[i:i + batch]).sum()
    return int(hits) / len(x)
