"""The benchmark's files against the format they keep, on the CPU: what it
imports, the names and limits of ``BENCHMARK.json``, and that every cell
finds its configuration, traffic, entry, limits and metric readers."""
import ast
import json
import math
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "cwbnwp_letkf_tpu"}


def imported(path: Path):
    """Top-level names of the absolute imports of one source file, and
    whether it has relative ones."""
    names, relative = set(), False
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative = True
            else:
                names.add(node.module.split(".")[0])
    return names, relative


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        names, _ = imported(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        assert not names & {"bench", "chip_smoke", "jacobi_ab", "tests"}, path


def test_the_reference_takes_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names, relative = imported(path)
        assert "cwbnwp_letkf_torch" not in names, path
        assert not relative, path   # nor anything of the harness


def test_the_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["letkf_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells of 14 runs each, with their builds, fit in 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for section, keys in (("configs", {"name", "source", "file", "reduced",
                                       "why"}),
                          ("workloads", {"name", "config", "traffic", "chips",
                                         "why"}),
                          ("end_to_end", {"name", "unit", "better", "bound",
                                          "source"}),
                          ("per_layer", {"name", "unit", "better", "source",
                                         "layer", "moves"})):
        for entry in BENCH[section]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]), entry["name"]
            assert (section, entry["name"]) not in seen
            seen.add((section, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200, entry[key]
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for conf in BENCH["configs"]:
        assert all(NAME.match(k) for k in conf["reduced"])
        assert len(conf["reduced"]) <= 16
        # no width is cut: the members (the k of every k x k solve), nor a
        # key ending in _dim or _rank
        assert not any(k == "nmember" or k.endswith(("_dim", "_rank"))
                       for k in conf["reduced"]), conf["reduced"]
    for wl in BENCH["workloads"]:
        assert NAME.match(wl["config"]) and NAME.match(wl["traffic"])
        assert wl["chips"] in (1, 4)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(wl):
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("letkf_bench/")
    for key in conf["reduced"]:
        assert key in cfg, key
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    assert (HERE / "entries" / f"{traffic['entry']}.py").is_file()
    assert set(traffic["platforms"]) <= set(cfg["platforms"])
    cell = json.loads((HERE / "cells" / f"{wl['name']}.json").read_text())
    assert cell["limits"] and all(math.isfinite(v) and v > 0
                                  for v in cell["limits"].values())
    if "numbers" in cell:   # each compared number has its limit
        assert set(cell["numbers"]) == set(cell["limits"])
        assert all(set(v) <= set(cfg["var_update"])
                   for v in cell["numbers"].values())
    mine = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
            if wl["name"] in m.get("workloads", [wl["name"]])]
    for m in mine:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    e2e = {m["name"] for m in mine if m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m for m in mine if m in BENCH["per_layer"]]
    assert per_layer and {m["moves"] for m in per_layer} <= e2e


def test_configuration_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_a_process_holding_jax_prints_no_result(monkeypatch):
    import sys
    import types

    import cwbnwp_letkf_torch  # noqa: F401

    from letkf_bench import run

    run.check_modules()     # the port's name begins with the JAX package's
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    with pytest.raises(SystemExit) as stop:
        run.check_modules()
    assert stop.value.code == 3
