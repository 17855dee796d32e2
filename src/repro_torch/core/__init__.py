"""The federated runner (port of ``repro.core``): client sampling and
grouping, the sequential client engine's host half, Eq. 2 aggregation,
the client store, the round executor and ``FederatedRunner``."""
