"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its files, all under the benchmark's folder:

* ``workloads/<cell>.json``: the entry it drives (``entries/<entry>.py``),
  the stage tail (``fused_tail``) and the limits of its comparison;
* ``configs/<config>.json``: the file that ``BENCHMARK.json``'s
  configuration entry names: widths, precision, TF32 switches;
* ``traffic/<traffic>.json``: the parameters of the inputs
  (:mod:`benchmark.traffic`).

Per-layer metrics are read by ``metrics/<name>.py``, or, for a name with
a dot, ``metrics/<part before the dot>.py``.  A later cell, traffic mix or
metric is a new file and a new entry; no code changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """A name, unit or file that the contract refuses, or a name that
    nothing defines."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 letters, digits, "
                        "'_', '.' and '-', starting with a letter, digit "
                        "or '_'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise SpecError(f"unit {unit!r} of {what}: 1-16 letters, digits, "
                        "'_', '/', '%', '.' and '-'")
    return unit


def _read(path: Path) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None


@dataclasses.dataclass
class Metric:
    """A metric that a cell reports: its name and unit."""

    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    """One workload with everything its files say."""

    name: str
    chips: int
    entry: str
    fused_tail: bool
    limits: Dict[str, float]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path

    @property
    def dtype_name(self) -> str:
        return self.config["dtype"]


def load_benchmark(root: Path) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder ``root``."""
    bench = _read(root.parent / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            check_name(entry["name"], key)
    for m in bench["end_to_end"] + bench["per_layer"]:
        check_unit(m["unit"], m["name"])
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"{m['name']}: better is lower or higher")
    return bench


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    :class:`SpecError` for a name it does not define."""
    check_name(name, "workload")
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (it has "
                        f"{', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_name = check_name(w["config"], "config")
    if config_name not in configs:
        raise SpecError(f"workload {name!r} names config {config_name!r}, "
                        "which BENCHMARK.json does not define")
    config = _read(root.parent / configs[config_name]["file"])
    traffic_name = check_name(w["traffic"], "traffic")
    traffic = _read(root / "traffic" / f"{traffic_name}.json")
    cell = _read(root / "workloads" / f"{name}.json")
    entry = check_name(cell["entry"], "entry")
    if not (root / "entries" / f"{entry}.py").is_file():
        raise SpecError(f"workload {name!r}: no entries/{entry}.py")
    if w["chips"] not in (1, 4):
        raise SpecError(f"workload {name!r}: chips is 1 or 4")
    e2e, layer = ([Metric(m["name"], m["unit"]) for m in bench[key]
                   if m.get("workloads") is None or name in m["workloads"]]
                  for key in ("end_to_end", "per_layer"))
    for m in layer:
        reader_path(root, m.name)  # a metric without its reader is refused
    return Cell(name=name, chips=w["chips"], entry=entry,
                fused_tail=bool(cell.get("fused_tail", False)),
                limits=dict(cell["limits"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer, root=root)


def reader_path(root: Path, metric: str) -> Path:
    for stem in (metric, metric.split(".", 1)[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.is_file():
            return path
    raise SpecError(f"metric {metric!r} has no reader metrics/{metric}.py "
                    f"or metrics/{metric.split('.', 1)[0]}.py")


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
