"""The systems under test: one module a kind of entry point.

A configuration file names its system (``"system": "dense_odometry"``);
``slambench.plugins.load("systems", name)`` finds ``systems/<name>.py``,
whose ``Driver`` feeds the program scan by scan and whose ``check`` judges
what it returned against the plain reference. A new kind of entry point
is a new file here; a new configuration of an existing kind is a new
configuration file.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def from_json(default: Any, values: Dict) -> Any:
    """A copy of the dataclass instance ``default`` with ``values`` set:
    a field whose default is itself a dataclass takes a nested object, a
    list becomes a tuple, and a key the class lacks raises."""
    names = {f.name for f in dataclasses.fields(default)}
    kw = {}
    for k, v in values.items():
        if k not in names:
            raise KeyError(f"{type(default).__name__} has no field {k!r}")
        cur = getattr(default, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = from_json(cur, v)
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return dataclasses.replace(default, **kw)
