"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
units, bounds, and every cell's configuration, traffic and metric files
found by name."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

REPO = Path(__file__).resolve().parent.parent
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_time():
    """A full check of 24 cells at this window fits 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                         "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in [e["name"] for e in MAN["end_to_end"]]
    for w in m.get("workloads", []):
        assert w in CELLS
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    # each metric's reader is found by name
    assert callable(harness.load_metric(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c, config, traffic, e2e, layer = harness.cell_of(MAN, cell)
    assert c["chips"] == 1
    assert {"name", "config", "traffic", "chips", "why"} == set(c)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
    assert config["family"] and config["k"] >= 2
    bench = REPO / "bench"
    assert (bench / "entries" / f"{traffic['entry']}.py").is_file()
    for folder in ("stages", "reference"):
        assert (bench / folder / f"{traffic['replay']}.py").is_file()


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = REPO / entry["file"]
    assert path.resolve().is_relative_to(REPO / "bench")
    config = json.loads(path.read_text())
    assert config["reduced"] == entry["reduced"]
    assert all(NAME.match(k) and k in config for k in entry["reduced"])
    assert entry["name"] in {c["config"] for c in MAN["workloads"]}
    assert len({e["file"] for e in MAN["configs"]}) == len(MAN["configs"])
