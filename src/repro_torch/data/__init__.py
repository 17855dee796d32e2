"""Synthetic data and client partitions (port of ``repro.data``)."""
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import (SyntheticClassification, make_lm_batch,  # noqa: F401
                                        make_model_batch)
