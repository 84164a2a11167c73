"""Typed config layer (counterpart of ``dispatches_tpu/core/config.py``,
a copy: the module is pure Python).

One typed tier for the options of the port's entry scripts: frozen
dataclasses with declared fields, validation at construction (type
coercion, bounds, choices), dict/JSON round-trips for checkpointing, and
argparse integration.

Usage::

    @config
    class MarketOptions:
        sced_horizon: int = config_field(4, bounds=(1, 48),
                                         doc="SCED lookahead hours")
        ...

    opts = MarketOptions(sced_horizon=8)      # validated
    opts.replace(sced_horizon=2)              # functional update
    MarketOptions.from_dict(opts.to_dict())   # round-trip
    MarketOptions.add_cli_args(parser); MarketOptions.from_cli(args)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type


class ConfigError(ValueError):
    """Raised when a config value fails validation."""


def config_field(default=dataclasses.MISSING, *, doc: str = "",
                 bounds: Optional[Tuple] = None, choices=None,
                 cli: bool = True, required: bool = False,
                 factory=dataclasses.MISSING):
    """Declare a validated config field.

    ``bounds=(lo, hi)`` are inclusive; either end may be None.
    ``choices`` restricts to an explicit set.  ``cli=False`` hides the
    field from generated argparse options (e.g. non-scalar fields).
    ``required=True`` marks the generated CLI option required (argparse
    usage error when omitted) and drops any default, so plain
    construction without the field is a TypeError — declare required
    fields before defaulted ones (dataclass ordering rule).
    """
    meta = {"doc": doc, "bounds": bounds, "choices": choices, "cli": cli,
            "required": required}
    if required:
        return dataclasses.field(metadata=meta)
    if factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=factory, metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


_COERCE: Dict[type, Any] = {
    int: int, float: float, str: str, Path: Path,
}


def _unwrap_optional(tp):
    """Optional[T] -> (T, True); T -> (T, False)."""
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _coerce(name: str, tp, value):
    tp, optional = _unwrap_optional(tp)
    if value is None:
        if optional:
            return None
        raise ConfigError(f"{name}: None is not allowed")
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return tp.from_dict(value) if hasattr(tp, "from_dict") else tp(**value)
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        raise ConfigError(f"{name}: cannot interpret {value!r} as bool")
    if tp is float and isinstance(value, (int, float)):
        return float(value)
    if tp is int:
        if isinstance(value, bool) or not isinstance(
            value, (int, float, str)
        ):
            raise ConfigError(f"{name}: cannot interpret {value!r} as int")
        try:
            f = float(value)
        except ValueError as exc:
            raise ConfigError(
                f"{name}: cannot interpret {value!r} as int"
            ) from exc
        if f != int(f):
            raise ConfigError(f"{name}: {value!r} is not an integer")
        return int(f)
    coercer = _COERCE.get(tp)
    if coercer is not None and not isinstance(value, tp):
        try:
            return coercer(value)
        except (TypeError, ValueError) as exc:
            raise ConfigError(
                f"{name}: cannot interpret {value!r} as {tp.__name__}"
            ) from exc
    return value


def _validate_field(obj, f: dataclasses.Field, tp):
    value = getattr(obj, f.name)
    qual = f"{type(obj).__name__}.{f.name}"
    value = _coerce(qual, tp, value)
    meta = f.metadata or {}
    bounds = meta.get("bounds")
    if bounds is not None and value is not None:
        lo, hi = bounds
        if lo is not None and value < lo:
            raise ConfigError(f"{qual}: {value!r} < lower bound {lo!r}")
        if hi is not None and value > hi:
            raise ConfigError(f"{qual}: {value!r} > upper bound {hi!r}")
    choices = meta.get("choices")
    if choices is not None and value is not None and value not in choices:
        raise ConfigError(
            f"{qual}: {value!r} not in allowed choices {list(choices)!r}"
        )
    if meta.get("required") and value is None:
        raise ConfigError(f"{qual} is required")
    object.__setattr__(obj, f.name, value)


def _class_hints(cls) -> Dict[str, Any]:
    """Resolved type hints, computed once per class (string annotations
    from ``from __future__ import annotations`` are eval'd only on the
    first construction, not per field per instance)."""
    hints = cls.__dict__.get("__config_hints__")
    if hints is None:
        hints = typing.get_type_hints(cls)
        cls.__config_hints__ = hints
    return hints


def _to_jsonable(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _to_jsonable(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if hasattr(value, "item") and getattr(value, "shape", None) == ():
        return value.item()  # numpy scalar
    if hasattr(value, "tolist"):
        return value.tolist()  # numpy array
    return value


def config(cls: Type) -> Type:
    """Class decorator: frozen dataclass + construction-time validation
    + dict/JSON round-trips + argparse integration."""
    orig_post = getattr(cls, "__post_init__", None)

    def __post_init__(self):
        hints = _class_hints(type(self))
        for f in dataclasses.fields(self):
            _validate_field(self, f, hints[f.name])
        if orig_post is not None:
            orig_post(self)

    # must be attached BEFORE dataclass() generates __init__ — the
    # generated __init__ only calls __post_init__ if it exists then
    cls.__post_init__ = __post_init__
    cls = dataclasses.dataclass(frozen=True)(cls)

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    @classmethod
    def from_dict(kls, d: dict):
        names = {f.name for f in dataclasses.fields(kls)}
        unknown = set(d) - names
        if unknown:
            raise ConfigError(
                f"{kls.__name__}: unknown config keys {sorted(unknown)!r}"
            )
        return kls(**d)

    def to_json(self, path=None) -> str:
        s = json.dumps(self.to_dict(), indent=1)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_json(kls, source):
        """Load from a JSON string or a file path.  A ``Path`` is always
        read as a file (missing file -> FileNotFoundError, not a
        misleading JSONDecodeError); a ``str`` is treated as a path only
        when a file exists there."""
        if isinstance(source, Path):
            text = source.read_text()
        elif isinstance(source, str) and source.lstrip().startswith(
            ("{", "[")
        ):
            text = source  # structurally JSON, even if a file shadows it
        elif isinstance(source, str) and "\n" not in source and Path(
            source
        ).exists():
            text = Path(source).read_text()
        else:
            text = str(source)
        return kls.from_dict(json.loads(text))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def add_cli_args(kls, parser: argparse.ArgumentParser,
                     prefix: str = "") -> argparse.ArgumentParser:
        hints = _class_hints(kls)
        for f in dataclasses.fields(kls):
            meta = f.metadata or {}
            if not meta.get("cli", True):
                continue
            tp, _ = _unwrap_optional(hints[f.name])
            if dataclasses.is_dataclass(tp):
                tp.add_cli_args(parser, prefix=f"{prefix}{f.name}.")
                continue
            if tp not in (int, float, str, bool, Path):
                continue
            default = (f.default if f.default is not dataclasses.MISSING
                       else (f.default_factory()
                             if f.default_factory is not dataclasses.MISSING
                             else None))
            kw: Dict[str, Any] = {"default": default,
                                  "help": meta.get("doc", "")}
            if meta.get("required"):
                kw["required"] = True
                del kw["default"]
            if meta.get("choices") is not None:
                kw["choices"] = list(meta["choices"])
            if tp is bool:
                # --x / --no-x flag pairs, keeping the validated default
                kw["action"] = argparse.BooleanOptionalAction
            elif tp is Path:
                kw["type"] = Path
            else:
                kw["type"] = tp
            parser.add_argument(f"--{prefix}{f.name}", **kw)
        return parser

    @classmethod
    def from_cli(kls, args: argparse.Namespace, prefix: str = ""):
        hints = _class_hints(kls)
        values = {}
        for f in dataclasses.fields(kls):
            meta = f.metadata or {}
            tp, _ = _unwrap_optional(hints[f.name])
            if dataclasses.is_dataclass(tp) and meta.get("cli", True):
                values[f.name] = tp.from_cli(args, prefix=f"{prefix}{f.name}.")
                continue
            key = f"{prefix}{f.name}".replace(".", "_")
            attr = f"{prefix}{f.name}"
            if hasattr(args, attr):
                values[f.name] = getattr(args, attr)
            elif hasattr(args, key):
                values[f.name] = getattr(args, key)
        return kls(**values)

    cls.to_dict = to_dict
    cls.from_dict = from_dict
    cls.to_json = to_json
    cls.from_json = from_json
    cls.replace = replace
    cls.add_cli_args = add_cli_args
    cls.from_cli = from_cli
    cls.__is_config__ = True
    return cls
