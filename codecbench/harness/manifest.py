"""Everything a run needs, found by name from ``BENCHMARK.json``: the
cell's entry, its configuration file, its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<workload>.json``) and one reader per metric
(``metrics/<metric>.py``, whose ``read(ctx)`` returns a number or None),
and the configuration's architecture (``architectures/<name>.py``, named
by the configuration's ``"architecture"``).  A later cell, mix, metric or
architecture is a new file here; nothing is edited."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "codecbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those that list the cell, or list none and move an
        end-to-end metric the cell reports."""
        e2e = [m for m in self.data["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in names)]

    def reader(self, metric: str) -> ModuleType:
        return load_file(self.dir / "metrics" / f"{metric}.py")

    def architecture(self, config: Dict) -> ModuleType:
        """The module of the configuration's architecture; an unknown name
        raises KeyError with the known ones."""
        name = config.get("architecture")
        path = self.dir / "architectures" / f"{name}.py"
        if not (isinstance(name, str) and re.fullmatch(r"\w+", name)
                and path.is_file()):
            known = sorted(p.stem for p in
                           (self.dir / "architectures").glob("*.py"))
            raise KeyError(f"unknown architecture {name!r}; known: {known}")
        return load_file(path)


def load_file(path: Path) -> ModuleType:
    """A metric reader, a roofline's byte count or an architecture,
    loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "codecbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
