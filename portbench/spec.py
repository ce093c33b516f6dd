"""``BENCHMARK.json`` and the files it names, found by name.

The checkout's root is the directory above ``portbench/``. A cell's
configuration file is its config's ``file``; its traffic mix is
``portbench/traffic/<traffic>.json``; what decides its ``correct`` is
``portbench/workloads/<cell>.json``; a per-layer metric's reader is
``portbench/metrics/<metric>.py``; a configuration's ``arch`` names
``portbench/arch/<arch>.py``.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file's contents
    traffic: dict       # the traffic mix's parameters
    workload: dict      # what decides correct
    end_to_end: list    # BENCHMARK.json's metrics this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name, w["chips"], load_json(root / cfg["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "workloads" / f"{name}.json"), e2e,
                per_layer)


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def arch(name: str):
    """``portbench.arch.<name>``: how the program builds the model."""
    return importlib.import_module(f"portbench.arch.{name}")


def reference(name: str):
    """``portbench.reference.<name>``: the model's plain reference."""
    return importlib.import_module(f"portbench.reference.{name}")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's ``--seed``."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def names(kind: str, root: Path = ROOT) -> List[str]:
    """The names of the files of one kind (``configs``, ``traffic``,
    ``workloads``, ``metrics``) present under ``portbench/``."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (HERE / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))
