"""PartitionSpec policies (port of ``repro.sharding``): ``specs``."""
from repro_torch.sharding.specs import (  # noqa: F401
    batch_pspec, cache_pspec, param_pspec
)
