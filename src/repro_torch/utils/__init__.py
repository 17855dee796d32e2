"""Tree algebra and the H100 roofline (port of ``repro.utils``)."""
from repro_torch.utils import hlo, pytree  # noqa: F401
