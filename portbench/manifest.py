"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a data file of its own: ``configs/<config>.json`` (the file the
configuration entry names), ``traffic/<traffic>.json`` and
``checks/<cell>.json`` (the limit of each number that decides ``correct``).
Each metric is a reader ``metrics/<metric>.py`` with a function
``read(ctx)`` that returns a number or None. A later PR adds a
configuration, a traffic mix, a cell or a metric by adding such files and
entries, with no edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

__all__ = ["Cell", "Manifest", "NAME_RE", "UNIT_RE", "load"]

HERE = pathlib.Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of the manifest with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: tuple  # metric entries this cell reports without a trace
    per_layer: tuple  # metric entries this cell reports with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Manifest:
    """The parsed manifest, rooted at ``base`` (the benchmark's folder)."""

    def __init__(self, data: dict, base: pathlib.Path = HERE) -> None:
        self.data = data
        self.base = base
        self.root = base.parent

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        names = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {names})")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> pathlib.Path:
        return self.root / self.config_entry(name)["file"]

    def traffic_path(self, name: str) -> pathlib.Path:
        return self.base / "traffic" / f"{name}.json"

    def checks_path(self, cell: str) -> pathlib.Path:
        return self.base / "checks" / f"{cell}.json"

    def metric_path(self, name: str) -> pathlib.Path:
        return self.base / "metrics" / f"{name}.py"

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        return Cell(
            name=name,
            chips=int(w["chips"]),
            config=json.loads(self.config_path(w["config"]).read_text()),
            traffic=json.loads(self.traffic_path(w["traffic"]).read_text()),
            checks=json.loads(self.checks_path(name).read_text()),
            end_to_end=tuple(m for m in self.data["end_to_end"] if _reports(m, name)),
            per_layer=tuple(m for m in self.data["per_layer"] if _reports(m, name)),
        )

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``, loaded by path
        so that any metric name serves as the file's name."""
        path = self.metric_path(metric)
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        if spec is None or spec.loader is None:
            raise ImportError(f"no reader for metric {metric!r} at {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load(path: pathlib.Path | None = None, base: pathlib.Path = HERE) -> Manifest:
    """Read ``BENCHMARK.json`` (by default the one at the checkout's root)."""
    path = path or base.parent / "BENCHMARK.json"
    return Manifest(json.loads(pathlib.Path(path).read_text()), base)
