"""Architecture config registry (``repro_torch.configs.get`` / ``names``)."""
from .base import (SHAPES, SUBQUADRATIC, ModelConfig,  # noqa: F401
                   ShapeConfig, get, names, reduced, register)
