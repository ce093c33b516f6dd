"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import math
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        for key in ("source", "why"):
            assert 1 <= len(c[key]) <= 200 and "\n" not in c[key]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    spec.arch(cell.config["arch"])
    spec.reference(cell.config["arch"])
    for key in ("frames", "sources", "compute_dtype", "frame_chunk",
                "winograd", "mixture_mean", "mixture_std",
                "trace_replays"):
        assert key in cell.traffic
    work = cell.workload
    assert work["control"] in ("tf32", "bf16", "fp8")
    for number, c in work["compare"].items():
        assert number in ("x_p99_db", "x_gap_db", "x_rms_db")
        assert math.isfinite(c["limit"]) and c["limit"] > 0
    assert {m["name"] for m in cell.end_to_end} == {"sep_step_ms",
                                                    "setup_s"}
    assert len(cell.per_layer) == 5


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_every_file_is_named_somewhere():
    """No config, traffic, workload or metric file that nothing names."""
    assert spec.names("configs") == sorted(
        c["file"].split("/")[-1][:-5] for c in BENCH["configs"])
    assert spec.names("traffic") == sorted(
        {w["traffic"] for w in BENCH["workloads"]})
    assert spec.names("workloads") == sorted(CELLS)
    assert spec.names("metrics") == sorted(
        m["name"] for m in BENCH["per_layer"])


def test_derived_seeds_differ_and_repeat():
    big = 2 ** 31 + 12345
    assert spec.derive(big, "inputs") == spec.derive(big, "inputs")
    assert spec.derive(big, "inputs") != spec.derive(big, "weights", 0)
    assert 0 <= spec.derive(big, "x") < 2 ** 63


def test_config_files_are_json_objects():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert isinstance(data, dict) and "assumed" in data
