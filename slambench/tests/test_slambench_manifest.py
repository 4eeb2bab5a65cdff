"""BENCHMARK.json against the benchmark's contract: names, units, files,
and what each per-layer metric moves."""

import json
import re

import pytest

from slambench.tests.tiny_cells import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(manifest["command"]) <= 32
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer"):
                    assert TEXT.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_files_and_cells(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("slambench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
    for w in manifest["workloads"]:
        assert (REPO / "slambench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_part_a_cell_names_has_its_file(manifest):
    """The system, world, sensor and route of each cell, and each
    per-layer metric's reader, are files of their own, named as a
    manifest name is."""
    parts = [("metrics", m["name"]) for m in manifest["per_layer"]]
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        parts += [("systems", cfg["system"]), ("worlds", cfg["world"]["kind"]),
                  ("sensors", cfg["sensor"]["model"])]
    for w in manifest["workloads"]:
        traffic = json.loads((REPO / "slambench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        parts.append(("routes", traffic["route"]["shape"]))
    for folder, name in parts:
        assert NAME.match(name), name
        assert (REPO / "slambench" / folder / f"{name}.py").is_file()


def test_metrics_and_moves(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25

    def reports(cell, metric):
        return cell in metric.get("workloads", cells)

    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (REPO / "slambench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(cell, e2e[m["moves"]])
    for cell in cells:
        assert sum(reports(cell, m) for m in e2e.values()) >= 2
        assert any(reports(cell, m) for m in manifest["per_layer"])
