"""The federated runner (port of ``repro.core``): client sampling and
grouping, the round plans and the vectorized client engine, Eq. 2
aggregation, the client store, the round executor and
``FederatedRunner``."""
__all__ = ["FedConfig", "FedState", "FederatedRunner", "PRESETS", "make_runner"]


def __getattr__(name: str):
    """The runner's names, imported on first use: ``distill`` imports
    ``core.step_graph``, so an eager import of ``core.fedsdd`` here (which
    imports ``distill``) would be a cycle."""
    if name in __all__:
        from repro_torch.core import fedsdd
        return getattr(fedsdd, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
