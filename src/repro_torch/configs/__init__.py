"""Model and input-shape configurations of the language-model slice
(port of ``repro.configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    LM_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_shape,
)
