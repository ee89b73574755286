"""``BENCHMARK.json`` against the contract's shape, and the harness's lookup by name."""

import json
import re

import pytest

from benchmark import manifest

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(manifest.NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["source"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_cells_pairs_configs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_names_an_end_to_end_metric_each_of_its_cells_reports(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert moved in manifest.end_to_end(BENCH, cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry and wrapper", "model step", "kernels", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_a_cells_files_by_name(cell):
    w = manifest.cell(BENCH, cell)
    cfg = manifest.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    mix = manifest.traffic(w["traffic"])
    kind = manifest.kind_module(mix["kind"])
    assert hasattr(kind, "Work") and any(m["name"] == kind.RATE for m in BENCH["end_to_end"])
    assert manifest.limits(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_the_harness_finds_a_metric_reader_by_name(metric):
    assert callable(manifest.metric_module(metric).read)


def test_an_unknown_name_is_refused():
    with pytest.raises(KeyError):
        manifest.cell(BENCH, "no-such-cell")
    with pytest.raises(ValueError):
        manifest.traffic("../BENCHMARK")
