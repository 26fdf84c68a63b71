"""The port's ``scripts/`` flows (``sc_sfmlearner_release_tpu_torch/scripts``):
name for name the root ``scripts/``, each running only the port's CLIs
(``python -m sc_sfmlearner_release_tpu_torch.<cli>``) with flags that the
CLI's ``build_parser()`` accepts, setting no JAX variable; and one
``SMOKE=1 DEVICE=cpu`` run of the KITTI parity runbook end to end on the
CPU (prepare, pack, train, test_disp, eval_depth, test_vo, eval_odom).

The flags are read as bash expands them: each script runs once with a
``python`` first on ``PATH`` that records its arguments instead of running
them (and, for the train CLI, makes the experiment directory the runbooks
look for).
"""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_SCRIPTS = ROOT / "sc_sfmlearner_release_tpu_torch" / "scripts"
PACKAGE = "sc_sfmlearner_release_tpu_torch"
# What each script is run with: data roots for the runbooks' real-data mode.
ENVIRONMENTS = {
    "kitti_parity_runbook.sh": [{"SMOKE": "1"}, {"KITTI_RAW": "/data/raw",
                                                 "DEPTH_TEST": "/data/test",
                                                 "ODOM": "/data/odom",
                                                 "IMAGENET_WEIGHTS_DIR": "/data/w"}],
    "nyu_parity_runbook.sh": [{"SMOKE": "1"}, {"NYU_TRAIN": "/data/nyu",
                                               "NYU_TEST": "/data/nyu_test"}],
}
RECORDER = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["RECORD"], "a") as f:
    f.write(json.dumps([os.getcwd()] + args) + "\\n")
if args[:2] == ["-m", "{package}.train"]:
    os.makedirs(os.path.join("checkpoints", args[args.index("--name") + 1], "ts"),
                exist_ok=True)
"""


# Scripts of architectures that only the port trains (no root script runs them).
PORT_ONLY = ("train_manydepth_kitti.sh",)


def _scripts():
    return sorted(p.name for p in PORT_SCRIPTS.glob("*.sh"))


def test_script_names_equal_the_root_scripts():
    assert sorted(set(_scripts()) - set(PORT_ONLY)) == \
        sorted(p.name for p in (ROOT / "scripts").glob("*.sh"))
    assert set(PORT_ONLY) <= set(_scripts())
    assert len(_scripts()) == 13


@pytest.mark.parametrize("name", _scripts())
def test_scripts_set_no_jax_variable_and_name_no_root_cli(name):
    text = (PORT_SCRIPTS / name).read_text()
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
    assert not re.search(r"\b(JAX|PALLAS|XLA)_[A-Z_]+", text), name
    assert not re.search(r"sc_sfmlearner_release_tpu(?!_torch)", text), name
    # Only modules of the port run: no script file of the repository.
    assert not re.search(r"python3?\s+(?!-m\s)\S", code), name
    assert all(m.startswith(f"{PACKAGE}.") for m in re.findall(r"python3?\s+-m\s+(\S+)", code))
    assert text.startswith("#!/usr/bin/env bash\n") and "set -euo pipefail" in text


def _recorded(name, env, tmp_path):
    """Every ``python`` command of script ``name`` run with ``env``, as
    bash expanded it: ``[cwd, arg, ...]`` lists."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    fake = bin_dir / "python"
    fake.write_text(RECORDER.format(python=sys.executable, package=PACKAGE))
    fake.chmod(0o755)
    record = tmp_path / "record.jsonl"
    record.unlink(missing_ok=True)
    run = subprocess.run(
        ["bash", str(PORT_SCRIPTS / name)], cwd=tmp_path, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
                             RECORD=str(record), WORK=str(tmp_path / "work"), **env))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    return [json.loads(line) for line in record.read_text().splitlines()]


@pytest.mark.parametrize("name", _scripts())
def test_scripts_run_only_port_clis_with_flags_their_parsers_accept(name, tmp_path):
    commands = []
    for env in ENVIRONMENTS.get(name, [{}]):
        commands += _recorded(name, env, tmp_path)
    assert commands
    for cwd, *argv in commands:
        assert argv[0] == "-m" and argv[1].startswith(f"{PACKAGE}."), argv
        module = importlib.import_module(argv[1])
        args = module.build_parser().parse_args(argv[2:])  # exits on a flag it lacks
        if "device" in vars(args):
            assert args.device == "cuda", argv  # the card unless DEVICE asks otherwise
    shutil.rmtree(tmp_path / "work", ignore_errors=True)


@pytest.mark.parametrize("name", ["train_resnet50_depth_256.sh", "train_resnet50_pose_256.sh",
                                  "train_nyu.sh"])
def test_chip_smoke_config_runs_take_the_scripts_flags(name, tmp_path):
    """``chip_smoke.py``'s ``[configs]`` phase reads each script's train
    command: exactly the flags the script passes, apart from the listed
    overrides (TRAIN_SET and the weights directory through the script's own
    variables; ``--epochs``, ``--epoch-size``, ``--name``), and it refuses
    any other override. It is read without a card."""
    import chip_smoke

    env = {"TRAIN_SET": "/data/set", "IMAGENET_WEIGHTS_DIR": "/data/weights"}
    (command,) = [c for c in _recorded(name, env, tmp_path) if c[2] == f"{PACKAGE}.train"]
    script = command[3:]
    read = chip_smoke.script_train_argv(name, env["TRAIN_SET"], env["IMAGENET_WEIGHTS_DIR"])
    assert read == script
    assert read[0] == "/data/set" and read[read.index("--imagenet-weights-dir") + 1] == \
        "/data/weights"
    overrides = {"--epochs": "2", "--epoch-size": "16", "--name": "config"}
    assert tuple(overrides) == chip_smoke.CONFIG_FLAG_OVERRIDES
    got = chip_smoke.config_argv(name, env["TRAIN_SET"], env["IMAGENET_WEIGHTS_DIR"], overrides)

    def without_overrides(argv):
        return [a for i, a in enumerate(argv)
                if a not in overrides and (i == 0 or argv[i - 1] not in overrides)]

    assert without_overrides(got) == without_overrides(script)
    for flag, value in overrides.items():
        assert got.count(flag) == 1 and got[got.index(flag) + 1] == value
    with pytest.raises(ValueError, match="may be overridden"):
        chip_smoke.config_argv(name, env["TRAIN_SET"], env["IMAGENET_WEIGHTS_DIR"],
                               {"--device": "cpu"})


def test_kitti_runbook_smoke_on_the_cpu(tmp_path):
    """The whole chain through the port at the runbook's smoke sizes
    (64x128, B2, one epoch of 4 steps); its work directory is removed."""
    work = tmp_path / "work"
    leaked = ROOT / "checkpoints" / "parity_r18"  # where a run outside WORK would write
    before = sorted(leaked.iterdir()) if leaked.is_dir() else []
    run = subprocess.run(
        ["bash", str(PORT_SCRIPTS / "kitti_parity_runbook.sh")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, SMOKE="1", DEVICE="cpu", WORK=str(work), OMP_NUM_THREADS="2"))
    try:
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        assert "RUNBOOK COMPLETE" in run.stdout
        (ckpt,) = (work / "checkpoints" / "parity_r18").iterdir()
        for f in ("dispnet_model_best.pth.tar", "exp_pose_model_best.pth.tar"):
            assert (ckpt / f).is_file()
        pred = np.load(work / "results" / "predictions.npy")
        assert pred.shape == (4, 64, 128) and np.all(np.isfinite(pred))
        rows = np.loadtxt(work / "results" / "vo" / "09.txt")
        assert rows.shape == (12, 12) and np.all(np.isfinite(rows))
        metrics = run.stdout.split("a3 |")[1].split()
        assert all(np.isfinite(float(v)) for v in metrics[1:14:2])
        assert "ATE (m):" in run.stdout
        # Everything stays under WORK.
        assert (sorted(leaked.iterdir()) if leaked.is_dir() else []) == before
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Work directories that the runbooks must refuse to empty, from a fake tree
# ``tmp/fake`` holding ``repo`` (a copy of the script) and ``users/me`` (the
# home): (WORK, the directory it runs from), relative to ``tmp/fake``.
REFUSED_WORK = {"repository": ("repo", "."), "its parent": (".", "."),
                "relative parent": ("..", "repo"), "home": ("users/me", "."),
                "home's parent": ("..", "users/me")}


@pytest.mark.parametrize("name", ["kitti_parity_runbook.sh", "nyu_parity_runbook.sh"])
@pytest.mark.parametrize("case", sorted(REFUSED_WORK))
def test_runbooks_refuse_to_empty_the_repository_or_home(name, case, tmp_path):
    """Smoke mode empties WORK first: a WORK that is or holds the repository
    or $HOME is refused before anything runs. The script runs as a copy in
    a fake tree under ``tmp_path``, so a broken guard empties only that."""
    fake = tmp_path / "fake"
    scripts = fake / "repo" / PACKAGE / "scripts"
    scripts.mkdir(parents=True)
    shutil.copy(PORT_SCRIPTS / name, scripts / name)
    home = fake / "users" / "me"
    home.mkdir(parents=True)
    keep = [fake / "repo" / "keep", home / "keep"]
    for f in keep:
        f.write_text("")
    bin_dir = tmp_path / "bin"  # a python that runs nothing
    bin_dir.mkdir()
    (bin_dir / "python").write_text("#!/bin/sh\nexit 3\n")
    (bin_dir / "python").chmod(0o755)
    work, cwd = REFUSED_WORK[case]
    run = subprocess.run(
        ["bash", str(scripts / name)], cwd=fake / cwd, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, SMOKE="1", WORK=work, HOME=str(home),
                             PATH=f"{bin_dir}:{os.environ['PATH']}"))
    assert run.returncode == 1 and "refusing WORK" in run.stderr, run.stderr
    assert all(f.is_file() for f in keep)


@pytest.mark.parametrize("name", ["kitti_parity_runbook.sh", "nyu_parity_runbook.sh"])
def test_runbooks_take_a_work_directory_inside_the_repository(name, tmp_path):
    """A WORK below the repository (``build/...``, as chip_smoke.py's
    ``[scripts]`` phase uses) passes the guard: the copy reaches its first
    ``python`` step, which here fails on purpose."""
    scripts = tmp_path / "repo" / PACKAGE / "scripts"
    scripts.mkdir(parents=True)
    shutil.copy(PORT_SCRIPTS / name, scripts / name)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text("#!/bin/sh\nexit 3\n")
    (bin_dir / "python").chmod(0o755)
    run = subprocess.run(
        ["bash", str(scripts / name)], cwd=tmp_path, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, SMOKE="1", WORK="repo/build/work",
                             PATH=f"{bin_dir}:{os.environ['PATH']}"))
    assert run.returncode == 3 and "refusing WORK" not in run.stderr, run.stderr
    assert (tmp_path / "repo" / "build" / "work").is_dir()
