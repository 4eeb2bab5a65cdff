"""Find the benchmark's parts by name: one file each.

Every part that a cell names lives in a file of its own under
``slambench/<folder>/<name>.py`` of the checkout: ``systems`` (an entry
point's driver and check), ``worlds`` (the planar patches a world is made
of), ``routes`` (the sensor's poses), ``sensors`` (a LiDAR's scans) and
``metrics`` (the reader of one per-layer metric). A later cell adds a file
and an entry in ``BENCHMARK.json`` or in a configuration or traffic file,
and edits no file that is there.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import pathlib
import sys
from types import ModuleType
from typing import Optional

PACKAGE = pathlib.Path(__file__).resolve().parent
FOLDERS = ("systems", "worlds", "routes", "sensors", "metrics")


def load(folder: str, name: str,
         root: Optional[pathlib.Path] = None) -> ModuleType:
    """The module ``slambench/<folder>/<name>.py`` of the checkout at
    ``root`` (this package's own checkout when None), loaded once a
    process. A file of this package is imported under its package name,
    so that the parts that import one another share it."""
    if folder not in FOLDERS:
        raise ValueError(f"no part folder {folder!r}")
    base = PACKAGE if root is None else pathlib.Path(root) / "slambench"
    path = (base / folder / f"{name}.py").resolve()
    if not path.is_file():
        raise SystemExit(f"slambench: no {folder} part {name!r} ({path})")
    if path == (PACKAGE / folder / f"{name}.py").resolve():
        return importlib.import_module(f"slambench.{folder}.{name}")
    key = (f"slambench_part_{folder}_{name}_"
           f"{hashlib.sha1(str(path).encode()).hexdigest()[:10]}")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod
