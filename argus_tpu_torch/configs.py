"""Dataclass-driven CLI, a copy of `argus_tpu/configs.py` (a tyro
equivalent on argparse):

  * every dataclass field becomes `--kebab-case-name VALUE`
  * nested dataclasses become dotted prefixes (`--dataset-config.dataset-path ...`)
  * bools become paired flags (`--amp` / `--no-amp`)
  * tuples take N values (`--center-crop 256 256`), `none` clears Optionals
  * fields without defaults are required
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
from typing import Any, Optional, Sequence, Type, TypeVar, Union

T = TypeVar("T")

_MISSING = dataclasses.MISSING


def _is_dataclass_type(t) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _unwrap_optional(t):
    """Optional[X] -> (X, True); anything else -> (t, False)."""
    origin = typing.get_origin(t)
    if origin is Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return t, False


def _kebab(name: str) -> str:
    return name.replace("_", "-")


def _num_or_str(v: str):
    """Element caster for un-parameterized sequence annotations."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def _add_fields(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        ftype = hints.get(f.name, f.type)
        ftype, optional = _unwrap_optional(ftype)
        flag = f"--{prefix}{_kebab(f.name)}"
        has_default = f.default is not _MISSING or f.default_factory is not _MISSING

        if _is_dataclass_type(ftype):
            _add_fields(parser, ftype, prefix=f"{prefix}{_kebab(f.name)}.")
            continue

        if ftype is bool:
            group = parser.add_mutually_exclusive_group()
            dest = prefix + f.name
            group.add_argument(flag, dest=dest, action="store_true", default=argparse.SUPPRESS)
            group.add_argument(
                f"--no-{prefix}{_kebab(f.name)}", dest=dest, action="store_false", default=argparse.SUPPRESS
            )
            continue

        origin = typing.get_origin(ftype)
        # bare `tuple`/`list` annotations (get_origin is None) take the sequence
        # path too, with int-or-float element casting
        if origin in (tuple, list) or ftype in (tuple, list):
            args = typing.get_args(ftype)
            elem = args[0] if args else _num_or_str
            if elem is Ellipsis:
                elem = _num_or_str
            nargs = (
                "+"
                if (len(args) == 2 and args[1] is Ellipsis) or origin is list or not args
                else len(args)
            )
            parser.add_argument(
                flag,
                dest=prefix + f.name,
                nargs=nargs or "+",
                type=elem if callable(elem) else str,
                default=argparse.SUPPRESS,
                required=not has_default,
            )
            continue

        caster = ftype if ftype in (int, float, str) else str
        if optional:
            orig_caster = caster

            def caster(v, _c=orig_caster):  # noqa: E731
                return None if v.lower() == "none" else _c(v)

        parser.add_argument(
            flag,
            dest=prefix + f.name,
            type=caster,
            default=argparse.SUPPRESS,
            required=not has_default,
        )


def _build(cls, values: dict, prefix: str = ""):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        ftype = hints.get(f.name, f.type)
        ftype, _ = _unwrap_optional(ftype)
        key = prefix + f.name
        if _is_dataclass_type(ftype):
            sub_prefix = f"{prefix}{_kebab(f.name)}."
            if any(k.startswith(sub_prefix) for k in values) or (
                f.default is _MISSING and f.default_factory is _MISSING
            ):
                kwargs[f.name] = _build(ftype, values, prefix=sub_prefix)
            continue
        if key in values:
            v = values[key]
            if (typing.get_origin(ftype) is tuple or ftype is tuple) and isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


def cli(cls: Type[T], args: Optional[Sequence[str]] = None, description: Optional[str] = None) -> T:
    """Parse CLI args into an instance of dataclass `cls` (tyro.cli equivalent)."""
    parser = argparse.ArgumentParser(
        description=description or (cls.__doc__ or "").strip().splitlines()[0] if cls.__doc__ else None,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    _add_fields(parser, cls)
    namespace = parser.parse_args(sys.argv[1:] if args is None else list(args))
    values: dict[str, Any] = vars(namespace)
    return _build(cls, values)
