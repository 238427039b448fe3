"""Language-model scaffold, dense and MoE families (port of ``repro.models``)."""
from repro_torch.models.transformer import Model, make_model  # noqa: F401
