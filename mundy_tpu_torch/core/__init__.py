"""Core utilities: frozen dataclass containers, assertions, config.

Port of mundy_tpu/core. The reference's `pytree_dataclass` is
`frozen_dataclass` here: PyTorch has no pytrees.
"""

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field
from mundy_tpu_torch.core.errors import require, debug_assert
from mundy_tpu_torch.core.config import (
    ConfigError,
    validate_config,
    load_yaml,
    config_from_dict,
    config_to_dict,
)

__all__ = [
    "frozen_dataclass",
    "static_field",
    "require",
    "debug_assert",
    "ConfigError",
    "validate_config",
    "load_yaml",
    "config_from_dict",
    "config_to_dict",
]
