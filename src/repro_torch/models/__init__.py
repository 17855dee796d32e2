"""The model zoo (port of ``repro.models``)."""
from repro_torch.models import model_zoo  # noqa: F401
from repro_torch.models.model_zoo import Model, build_model  # noqa: F401
