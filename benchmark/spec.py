"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``traffic/<mix>.json``; its
correctness limits are ``limits/<cell>.json``; each per-layer metric is read
by ``metrics/<metric>.py``'s ``read(records)``. A configuration names its
family (``"family"``): ``families/<family>/`` holds the program it runs
(``program.py``), its plain reference (``reference.py``), its FLOPs
(``flops.py``) and its kernels' shapes and bytes (``kernels.py``). Adding a
configuration, a family, a mix, a cell or a metric is adding files and
entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import types
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, mix, limits and the
    metrics it reports; KeyError for an unknown cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = _json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(here, "limits", f"{workload}.json"))
    return Cell(workload, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str, root: str = ROOT) -> Callable[[Dict], object]:
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def family(name: str, part: str):
    """``families/<name>/<part>.py`` of this checkout (a configuration's
    ``"family"``), loaded by path once a process. The family's directory is a
    package of its own, so its files import each other relatively
    (``from . import reference``)."""
    directory = os.path.join(ROOT, "benchmark", "families", name)
    if not os.path.isfile(os.path.join(directory, f"{part}.py")):
        raise FileNotFoundError(f"family {name!r} has no {part}.py in {directory}")
    package = f"benchmark_family_{name}"
    if package not in sys.modules:
        module = types.ModuleType(package)
        module.__path__ = [directory]
        sys.modules[package] = module
    return importlib.import_module(f"{package}.{part}")
