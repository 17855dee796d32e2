"""The federated runner (port of ``repro.core``): client sampling and
grouping, the round plans and the vectorized client engine, Eq. 2
aggregation, the client store, the round executor and
``FederatedRunner``."""
