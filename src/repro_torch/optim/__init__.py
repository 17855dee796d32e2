"""Functional optimizers over tensor pytrees (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adam, sgd, with_fedprox,  # noqa: F401
                                          with_scaffold)
