"""Shared CLI plumbing: config overrides and structured run output.

Port of ``tpu_slam.cli.common``, with one fault of the reference fixed: a
comma value for a field whose default is None is read as a tuple of
numbers when every part is a number, and kept as the string otherwise
(the reference raises ValueError on the first part that is not a number).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``key.path=value`` overrides to a (nested) frozen dataclass,
    e.g. ``ndt.window_dims=48,48,16`` or ``map_leaf=0.3``."""
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"override {ov!r} is not key=value")
        path, raw = ov.split("=", 1)
        cfg = _set_path(cfg, path.split("."), raw)
    return cfg


def _number(p: str):
    try:
        return int(p)
    except ValueError:
        return float(p)


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        return tuple(_number(p) for p in raw.split(","))
    if current is None and "," in raw:
        try:
            return tuple(_number(p) for p in raw.split(","))
        except ValueError:
            return raw
    return raw


def _set_path(node: Any, keys: list[str], raw: str) -> Any:
    if not dataclasses.is_dataclass(node):
        raise SystemExit(f"cannot descend into non-config {node!r}")
    name = keys[0]
    if not hasattr(node, name):
        valid = [f.name for f in dataclasses.fields(node)]
        raise SystemExit(f"unknown config field {name!r}; valid: {valid}")
    current = getattr(node, name)
    if len(keys) == 1:
        return dataclasses.replace(node, **{name: _parse_value(raw, current)})
    return dataclasses.replace(node, **{name: _set_path(current, keys[1:],
                                                        raw)})


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config override, e.g. map_leaf=0.3")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable JSON summary on stdout")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, which must "
                        "be present; 'cpu' runs the plain PyTorch path)")


def emit(summary: dict, as_json: bool):
    if as_json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}", file=sys.stderr)
