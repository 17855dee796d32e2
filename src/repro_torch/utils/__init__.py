"""Tree algebra (port of ``repro.utils``)."""
from repro_torch.utils import pytree  # noqa: F401
