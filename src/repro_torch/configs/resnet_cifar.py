"""The paper's own model zoo: ResNet-20/56 and WRN16-2 on 32x32 images
[He et al. 2016; Zagoruyko & Komodakis 2016] (port of
``repro/configs/resnet_cifar.py``, copied field for field).

Configured through ``ResNetConfig`` (not ``ModelConfig``, which describes
the transformer families); the model lives in ``models/resnet.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    depth: int                 # 6n+2
    width_mult: int = 1        # WRN widening factor
    num_classes: int = 10
    norm: str = "group"        # "group" (FL-stable default) | "batch"
    source: str = "He et al. 2016 / Zagoruyko & Komodakis 2016"

    @property
    def num_blocks_per_stage(self) -> int:
        if (self.depth - 2) % 6 != 0:
            raise ValueError(f"depth must be 6n+2, got {self.depth}")
        return (self.depth - 2) // 6

    def reduced(self) -> "ResNetConfig":
        return dataclasses.replace(self, depth=8)


RESNET_CONFIGS: dict[str, ResNetConfig] = {
    "resnet20": ResNetConfig("resnet20", depth=20),
    "resnet56": ResNetConfig("resnet56", depth=56),
    "wrn16-2": ResNetConfig("wrn16-2", depth=14, width_mult=2),
}


def get_resnet_config(name: str, num_classes: int = 10) -> ResNetConfig:
    return dataclasses.replace(RESNET_CONFIGS[name], num_classes=num_classes)
