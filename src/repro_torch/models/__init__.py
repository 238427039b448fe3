"""Language-model scaffold, every family (port of ``repro.models``)."""
from repro_torch.models.transformer import Model, make_model  # noqa: F401
