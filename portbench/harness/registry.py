"""Find a cell's configuration, traffic mix, loop, limits and metric
readers by the names ``BENCHMARK.json`` gives them.

Nothing here knows a cell: a later cell, configuration, mix, loop, metric
or kernel is a new file under ``portbench/`` that these functions find.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

#: the checkout's root (the directory that holds ``BENCHMARK.json``)
ROOT = Path(__file__).resolve().parents[2]
#: the benchmark's own directory
BENCH = ROOT / "portbench"


def load_benchmark(path: Optional[Path] = None) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, key: str) -> ModuleType:
    """Import the Python file at ``path`` once a process, as ``key``."""
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def _key(kind: str, name: str) -> str:
    return "portbench_" + kind + "__" + name.replace(".", "_").replace(
        "-", "_")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration (the
    file's contents), its traffic mix and its correctness limits."""

    def __init__(self, bench: dict, name: str):
        self.bench = bench
        self.workload = _named(bench["workloads"], name, "workload")
        self.name = name
        self.config_entry = _named(bench["configs"],
                                   self.workload["config"], "config")
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = self.workload["traffic"]
        self.mix = load_json(BENCH / "traffic" / f"{self.traffic}.json")
        self.chips = int(self.workload["chips"])

    @property
    def limits(self) -> dict:
        """``limits/<cell>.json``: each compared number's limit."""
        return load_json(BENCH / "limits" / f"{self.name}.json")["limits"]

    def loop(self) -> ModuleType:
        """The loop module the traffic mix names (``loops/<loop>.py``)."""
        name = self.mix["loop"]
        return load_module(BENCH / "loops" / f"{name}.py",
                           _key("loop", name))

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def metric_reader(name: str) -> ModuleType:
    """A per-layer metric's reader: ``metrics/<name>.py``."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       _key("metric", name))


def roofline(kernel: str) -> ModuleType:
    """A kernel's operation and byte counts: ``roofline/<kernel>.py``."""
    return load_module(BENCH / "roofline" / f"{kernel}.py",
                       _key("roofline", kernel))


def reference(name: str) -> ModuleType:
    """A plain reference: ``reference/<name>.py``."""
    return load_module(BENCH / "reference" / f"{name}.py",
                       _key("reference", name))
