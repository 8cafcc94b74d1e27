"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) resolves by name to its configuration
file (``configs[].file``), its traffic mix ``traffic/<traffic>.json`` (whose
``driver`` key names ``drivers/<driver>.py``), its own file
``workloads/<cell>.json`` (the sample it judges and the limits of
``correct``) and the metric readers ``metrics/<metric>.py`` that report in
it. Adding a cell, a mix or a metric adds files; none is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict     # the configuration file
    traffic: dict    # the traffic mix file
    judge: dict      # workloads/<cell>.json
    end_to_end: tuple  # metric entries of BENCHMARK.json that report in this cell
    per_layer: tuple


def load_spec(path: Path = SPEC_FILE) -> dict:
    return json.loads(path.read_text())


def reports_in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or load_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text()),
        judge=json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text()),
        end_to_end=tuple(m for m in spec["end_to_end"] if reports_in(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if reports_in(m, name)),
    )


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, imported by path (a
    metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    mod_name = f"portbench.{kind}.{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    """The plain reference module of the configuration's family."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")
