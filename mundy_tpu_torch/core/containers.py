"""Frozen dataclass containers.

PyTorch runs eagerly and has no pytrees, so the reference's pytree
dataclasses (mundy_tpu/core/containers.py) become plain frozen dataclasses
with a `.replace` method. `static_field` stays as metadata that marks the
python scalars (counts, capacities) among the tensor fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> dataclasses.Field:
    """Mark a dataclass field as a static python scalar (never a tensor)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["mundy_static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def frozen_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass with a functional `.replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self: _T, **changes: Any) -> _T:
        return dataclasses.replace(self, **changes)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls
