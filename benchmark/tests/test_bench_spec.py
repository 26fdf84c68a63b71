"""BENCHMARK.json against the contract's characters and shapes, every cell
resolved to its files, and a throwaway configuration, mix, metric and cell
added as files and entries alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_one_line(w) for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _one_line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    assert all(set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
               and m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = spec.resolve(BENCH, workload)
    assert cell.chips in (1, 4)
    assert cell.config["name"] in [c["name"] for c in BENCH["configs"]]
    assert cell.limits["limits"] and set(cell.limits["limits"]) <= set(check.NUMBERS)
    assert all(0 < v < 1 for v in cell.limits["limits"].values())
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
    config = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert sorted(config["reduced"]) == sorted(cell.config["reduced"])
    assert config["file"].startswith(BENCH["paths"][0] + "/")


def test_files_under_paths_are_named_from_name_characters():
    for root, _, files in os.walk(os.path.join(spec.ROOT, "benchmark")):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), spec.ROOT)
            assert PATH.match(rel), rel


def test_throwaway_entries_need_no_code(tmp_path):
    """A new configuration, mix, metric and cell as files and entries in a
    copy of the benchmark: the harness finds and reads each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "pool"))
    bench = json.loads(json.dumps(BENCH))
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "sc_depth_r18_kitti.json").read_text())
    cfg.update(name="throwaway_cfg", batch_size=2)
    (here / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "packed_fused16.json").read_text())
    mix.update(name="throwaway_mix", scenes=9)
    (here / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (here / "limits" / "throwaway.cell.json").write_text(
        (here / "limits" / "r18_kitti.packed.json").read_text())
    (here / "metrics" / "throwaway.steps.py").write_text(
        "def read(rec):\n    return rec['window']['steps']\n")
    bench["configs"].append(dict(BENCH["configs"][0], name="throwaway_cfg",
                                 file="benchmark/configs/throwaway_cfg.json"))
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Entry points",
                               "moves": "snippets_per_s", "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve(spec.load_benchmark(str(root)), "throwaway.cell", str(root))
    assert cell.config["batch_size"] == 2 and cell.traffic["scenes"] == 9
    assert [m["name"] for m in cell.per_layer][-1] == "throwaway.steps"
    assert spec.reader("throwaway.steps", str(root))({"window": {"steps": 7}}) == 7
    with pytest.raises(KeyError):
        spec.resolve(bench, "no.such.cell", str(root))


def test_throwaway_cell_runs_on_the_cpu(tmp_path):
    """The same throwaway metric read in a tiny traced run on the CPU."""
    import torch

    from benchmark import run
    from benchmark.tests import tiny

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "pool"))
    bench = json.loads(json.dumps(BENCH))
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["throwaway.cell"]
    bench["workloads"].append({"name": "throwaway.cell", "config": "sc_depth_r18_kitti",
                               "traffic": "packed_fused16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Entry points",
                               "moves": "snippets_per_s", "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "limits" / "throwaway.cell.json").write_text(
        json.dumps({"reference": "fp32",
                    "limits": {"loss_rel": 0.5, "grad1_rel": 0.5, "update_rel": 0.5}}))
    (root / "benchmark" / "metrics" / "throwaway.steps.py").write_text(
        "def read(rec):\n    return rec['window']['steps']\n")
    cell = tiny.tiny_cell("throwaway.cell", tiny.tiny_pool(str(tmp_path / "pool")),
                          root=str(root))
    out = run.measure(cell, 3, 0.5, True, torch.device("cpu"), root=str(root))
    assert out["metrics"]["throwaway.steps"]["value"] == out["attempted"] * 2
    assert out["correct"] is True
