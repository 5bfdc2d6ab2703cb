"""Architecture config registry (``repro_torch.configs.get`` / ``names``)."""
from .base import ModelConfig, get, names, reduced, register  # noqa: F401
