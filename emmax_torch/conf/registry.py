"""Dataclass choice registry and CLI override parsing, the port's own
copy of ``emmax_tpu/conf/registry.py``.

Dataclass configs live in named registries and are selected on the CLI
with ``--<field>.type <choice-id>``; every other field takes a dotted-path
override (``--vla.max_steps 3``); the resolved config round-trips to JSON.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type, TypeVar

_T = TypeVar("_T")


class ChoiceRegistry:
    """Base class: subclasses register under a string id per registry root."""

    _registry: Dict[type, Dict[str, type]] = {}

    @classmethod
    def register_subclass(cls, choice_id: str, subclass: Optional[type] = None):
        root = cls
        reg = ChoiceRegistry._registry.setdefault(root, {})

        def _register(sub: type) -> type:
            if choice_id in reg and reg[choice_id] is not sub:
                raise ValueError(f"duplicate choice id {choice_id!r} for {root.__name__}")
            reg[choice_id] = sub
            sub.choice_id = choice_id
            return sub

        return _register(subclass) if subclass is not None else _register

    @classmethod
    def get_choice_class(cls, choice_id: str) -> type:
        reg = ChoiceRegistry._registry.get(cls, {})
        if choice_id not in reg:
            known = ", ".join(sorted(reg))
            raise KeyError(f"unknown {cls.__name__} choice {choice_id!r}; known: {known}")
        return reg[choice_id]


def _coerce(value: str, ann: Any) -> Any:
    """Coerce a CLI string to the annotated type."""
    origin = typing.get_origin(ann)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        for a in args:
            try:
                return _coerce(value, a)
            except (ValueError, TypeError):
                continue
        return value
    if ann in (str, Any) or ann is Path:
        return Path(value) if ann is Path else value
    if ann is bool:
        low = value.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"invalid boolean {value!r} (use true/false)")
    if ann in (int, float):
        return ann(value)
    if origin in (list, tuple):
        items = json.loads(value) if value.startswith("[") else value.split(",")
        inner = (typing.get_args(ann) or (str,))[0]
        seq = [_coerce(str(v), inner) for v in items]
        return tuple(seq) if origin is tuple else seq
    return value


def _set_dotted(cfg: Any, dotted: str, raw: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    field_name = parts[-1]
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if field_name not in fields:
        raise AttributeError(f"{type(obj).__name__} has no field {field_name!r}")
    hints = typing.get_type_hints(type(obj))
    setattr(obj, field_name, _coerce(raw, hints.get(field_name, str)))


def parse_config(root_cls: Type[_T], argv: Sequence[str],
                 choice_fields: Optional[Dict[str, Type[ChoiceRegistry]]] = None) -> _T:
    """Build ``root_cls()`` applying ``--a.b value`` overrides.

    ``choice_fields`` maps top-level field names to their ChoiceRegistry base;
    ``--<field>.type <id>`` swaps in the registered subclass *before* other
    overrides apply (the trainer's ``--vla.type <id>``).
    """
    choice_fields = choice_fields or {}
    pairs: List[tuple] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected CLI token {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            val = argv[i + 1]
            i += 2
        pairs.append((key, val))

    # choice selection first
    selections: Dict[str, str] = {}
    rest: List[tuple] = []
    for key, val in pairs:
        parts = key.split(".")
        if len(parts) == 2 and parts[1] == "type" and parts[0] in choice_fields:
            selections[parts[0]] = val
        else:
            rest.append((key, val))

    kwargs: Dict[str, Any] = {}
    for field_name, registry in choice_fields.items():
        if field_name in selections:
            kwargs[field_name] = registry.get_choice_class(selections[field_name])()
    cfg = root_cls(**kwargs)

    for key, val in rest:
        _set_dotted(cfg, key, val)
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        out = {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
        if hasattr(type(cfg), "choice_id"):
            out["type"] = type(cfg).choice_id
        return out
    if isinstance(cfg, Path):
        return str(cfg)
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    return cfg
