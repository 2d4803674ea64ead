"""Config: typed dataclass schemas populated from YAML/dicts with validation.

Port of mundy_tpu/core/config.py, which holds no JAX: any numeric type
coerces to the declared field type, unknown keys are rejected, and nested
sublists map to nested dataclasses.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Type, TypeVar, Union, get_args, get_origin

import yaml

_T = TypeVar("_T")


class ConfigError(ValueError):
    """Raised on schema violations (unknown key, bad type, failed check)."""


def load_yaml(path: str) -> dict:
    """Load a YAML file into a plain dict (safe loader)."""
    with open(path, "r") as f:
        out = yaml.safe_load(f)
    if out is None:
        return {}
    if not isinstance(out, dict):
        raise ConfigError(f"top-level YAML in {path} must be a mapping")
    return out


def _coerce(value: Any, typ: Any, path: str) -> Any:
    origin = get_origin(typ)

    if typ is Any:
        return value
    if origin is Union:
        args = get_args(typ)
        if type(None) in args and value is None:
            return None
        non_none = [a for a in args if a is not type(None)]
        errors = []
        for a in non_none:
            try:
                return _coerce(value, a, path)
            except ConfigError as e:  # noqa: PERF203
                errors.append(str(e))
        raise ConfigError(f"{path}: no Union arm matched ({'; '.join(errors)})")
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected sequence, got {type(value).__name__}")
        args = get_args(typ)
        if origin is list:
            elem_t = args[0] if args else Any
            return [_coerce(v, elem_t, f"{path}[{i}]") for i, v in enumerate(value)]
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0], f"{path}[{i}]") for i, v in enumerate(value))
        if args and len(args) != len(value):
            raise ConfigError(f"{path}: expected {len(args)} items, got {len(value)}")
        if args:
            return tuple(
                _coerce(v, a, f"{path}[{i}]") for i, (v, a) in enumerate(zip(value, args))
            )
        return tuple(value)
    if origin is dict:
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {type(value).__name__}")
        kt, vt = get_args(typ) or (Any, Any)
        return {
            _coerce(k, kt, f"{path}.key"): _coerce(v, vt, f"{path}[{k}]")
            for k, v in value.items()
        }
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        if isinstance(value, typ):
            return value
        try:
            return typ[value] if isinstance(value, str) else typ(value)
        except (KeyError, ValueError) as e:
            raise ConfigError(f"{path}: {value!r} not a valid {typ.__name__}") from e
    if dataclasses.is_dataclass(typ):
        if isinstance(value, typ):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping for {typ.__name__}")
        return config_from_dict(typ, value, path=path)
    if typ is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {type(value).__name__}")
    if typ is float:
        # "accept any number" semantics of OurAnyNumberParameterEntryValidator
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
        raise ConfigError(f"{path}: expected number, got {value!r}")
    if typ is int:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value == int(value):
            return int(value)
        if isinstance(value, str):
            try:
                return int(value)
            except ValueError:
                pass
        raise ConfigError(f"{path}: expected int, got {value!r}")
    if typ is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{path}: expected str, got {type(value).__name__}")
    if isinstance(typ, type) and isinstance(value, typ):
        return value
    raise ConfigError(f"{path}: cannot coerce {value!r} to {typ!r}")


def config_from_dict(cls: Type[_T], data: dict, path: str = "") -> _T:
    """Build dataclass `cls` from a dict, validating keys and coercing types."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{cls!r} is not a dataclass schema")
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise ConfigError(
            f"{path or cls.__name__}: unknown keys {sorted(unknown)}; "
            f"valid keys: {sorted(field_names)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints[f.name], f"{path}.{f.name}".lstrip("."))
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise ConfigError(f"{path or cls.__name__}: missing required key '{f.name}'")
    obj = cls(**kwargs)
    validate_config(obj, path=path)
    return obj


def config_to_dict(obj: Any) -> dict:
    """Dataclass config → plain dict (YAML-serializable)."""
    out = dataclasses.asdict(obj)

    def clean(v):
        if isinstance(v, enum.Enum):
            return v.name
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    return clean(out)


def validate_config(obj: Any, path: str = "") -> None:
    """Run the schema's own `__validate__` hook if present."""
    hook = getattr(obj, "__validate__", None)
    if hook is not None:
        try:
            hook()
        except (AssertionError, ValueError) as e:
            raise ConfigError(f"{path or type(obj).__name__}: {e}") from e
