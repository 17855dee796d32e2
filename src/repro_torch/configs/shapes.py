"""The four assigned input shapes (port of ``repro/configs/shapes.py``).

``kind`` selects which step a caller drives:
  train    -> a client local-training step
  prefill  -> forward + KV-cache / state build
  decode   -> ONE new token against a seq_len KV cache or recurrent state
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
