"""Typed-dataclass CLI parser (the port's copy of sheeprl_tpu/utils/parser.py).

  - every dataclass field becomes an argparse flag;
  - ``bool`` fields produce a ``--x`` / ``--no_x`` pair;
  - ``List[x]`` fields become ``nargs="+"``;
  - ``@file.args`` argument files are supported (fromfile prefix).

Configs are plain (non-frozen) dataclasses with inheritance-based
composition (StandardArgs -> DreamerV2Args -> DreamerV3Args).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Union, get_args, get_origin, get_type_hints


def Arg(
    default: Any = dataclasses.MISSING,
    *,
    help: str | None = None,
    default_factory: Any = dataclasses.MISSING,
    **kwargs: Any,
) -> Any:
    """Dataclass-field helper carrying argparse metadata."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    if help is not None:
        metadata["help"] = help
    if default_factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=default_factory, metadata=metadata, **kwargs)
    if default is dataclasses.MISSING:
        return dataclasses.field(metadata=metadata, **kwargs)
    if isinstance(default, (list, dict, set)):
        return dataclasses.field(
            default_factory=lambda: type(default)(default), metadata=metadata, **kwargs
        )
    return dataclasses.field(default=default, metadata=metadata, **kwargs)


def _unwrap_optional(tp: Any) -> tuple[Any, bool]:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


class DataclassArgumentParser(argparse.ArgumentParser):
    """argparse over one or more dataclass types."""

    def __init__(self, dataclass_types: Any, **kwargs: Any) -> None:
        kwargs.setdefault("fromfile_prefix_chars", "@")
        kwargs.setdefault("formatter_class", argparse.ArgumentDefaultsHelpFormatter)
        super().__init__(**kwargs)
        if dataclasses.is_dataclass(dataclass_types):
            dataclass_types = [dataclass_types]
        self.dataclass_types = list(dataclass_types)
        for dtype in self.dataclass_types:
            self._add_dataclass_arguments(dtype)

    def _add_dataclass_arguments(self, dtype: Any) -> None:
        hints = get_type_hints(dtype)
        for f in dataclasses.fields(dtype):
            if not f.init:
                continue
            self._add_field(f, hints[f.name])

    def _add_field(self, f: dataclasses.Field, tp: Any) -> None:
        tp, _optional = _unwrap_optional(tp)
        name = f.name
        kwargs: dict[str, Any] = {"help": f.metadata.get("help")}

        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
            kwargs["required"] = True

        origin = get_origin(tp)
        if tp is bool:
            group = self.add_mutually_exclusive_group(required=False)
            group.add_argument(
                f"--{name}", dest=name, action="store_true", help=kwargs["help"]
            )
            group.add_argument(f"--no_{name}", dest=name, action="store_false")
            self.set_defaults(**{name: default})
            return
        if origin in (list, tuple):
            item_tp = get_args(tp)[0] if get_args(tp) else str
            kwargs["nargs"] = "+"
            kwargs["type"] = item_tp
        else:
            kwargs["type"] = tp
        kwargs["default"] = default
        self.add_argument(f"--{name}", **kwargs)

    def parse_args_into_dataclasses(self, args: list[str] | None = None) -> tuple:
        """Dataclasses from `args` (sys.argv when None). Each output carries
        `_cli_provided`, the fields the command line set explicitly (not
        left at their defaults): a resumed or evaluated run lets exactly
        those override its checkpoint's config (`utils/evaluation.py`)."""
        namespace, remaining = self.parse_known_args(args)
        if remaining:
            raise ValueError(f"unknown arguments: {remaining}")
        provided = self._provided_flags(args)
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            out = dtype(**{k: v for k, v in vars(namespace).items() if k in keys})
            out._cli_provided = provided & keys
            outputs.append(out)
        return tuple(outputs)

    def _provided_flags(self, args: list[str] | None) -> set[str]:
        """Re-parse with every default suppressed: the namespace then holds
        exactly the dests the command line gave (through `--flag=value`,
        `--no_flag` and `@file.args` expansion alike)."""
        saved = [(a, a.default) for a in self._actions]
        saved_defaults = dict(self._defaults)
        for a in self._actions:
            a.default = argparse.SUPPRESS
        self._defaults.clear()
        try:
            namespace, _ = self.parse_known_args(args)
        finally:
            for a, d in saved:
                a.default = d
            self._defaults.update(saved_defaults)
        return set(vars(namespace))

    def parse_dict(self, args: dict[str, Any]) -> tuple:
        """Dataclasses from a dict of field values (a checkpoint's args.json
        sidecar). Keys no dataclass has are dropped: a sidecar written by
        the reference carries its TPU-side fields."""
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            outputs.append(dtype(**{k: v for k, v in args.items() if k in keys}))
        return tuple(outputs)
