"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a ``workloads`` entry; its ``config`` names
``configs/<config>.json`` (the ``configs`` entry's ``file``), its
``traffic`` names ``traffic/<traffic>.json``, whose ``kind`` names the
driver ``mixes/<kind>.py``; ``cells/<cell>.json`` holds the limits of the
numbers its run compares. A per-layer metric ``<base>.<path>`` is read by
``metrics/<base>.py``'s ``read(ctx, path)``.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = self.root / "portbench"

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.here / "cells" / f"{cell}.json").read_text())["limits"]

    def _metrics(self, key: str, cell: str) -> list:
        return [m for m in self.data[key] if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics a cell reports."""
        return self._metrics("end_to_end", cell)

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics a cell's traced run reports."""
        return self._metrics("per_layer", cell)


def mix(kind: str):
    """The traffic driver of ``kind``."""
    return importlib.import_module(f"portbench.mixes.{kind}")


def reader(metric: str):
    """(``read`` of ``metrics/<base>.py``, the path suffix) of a per-layer
    metric ``<base>.<path>``."""
    base, _, path = metric.partition(".")
    return importlib.import_module(f"portbench.metrics.{base}").read, path
