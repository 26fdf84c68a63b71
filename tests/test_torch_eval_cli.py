"""The port's evaluation and inference CLIs against the JAX package's.

Each JAX CLI runs as a subprocess (``tests/test_cli.py::_run``) and each
port CLI in-process with ``--device cpu --precision fp32``; both read the
same ``.pth.tar`` networks (seeded port networks with random BatchNorm
statistics and affine parameters) and the same 64x96 images of
``tests/test_cli.py``'s fixtures. Tolerances:

- ``test_disp`` ``predictions.npy``: rel 1e-4 at the network size, 1e-3
  through an area shrink from 100x150 (both ResNet-18 and ResNet-50);
- ``test_vo`` ``09.txt`` and ``test_pose`` ``predictions.npy`` with its
  ATE/RE: within 1e-4 of max|ref|;
- ``eval_depth`` mean errors: rel 1e-4 (KITTI and NYU);
- ``eval_odom`` ``result.txt`` and ``errors/``: rel 1e-9;
- ``run_inference`` PNGs: the same names, within one grey level.

Measured on the CPU: 2.34e-7, 2.32e-7 (ResNet-50 2.34e-7, 2.33e-7);
2.98e-7 and 2.38e-7 (ATE/RE 1.35e-7); 1.39e-8 (KITTI), 4.85e-8 (NYU); 0;
0 grey levels.

Also: each network CLI exits clearly with its default ``--device cuda``
when there is no card, every CLI answers ``--help``, and a ``.msgpack``
that is not a flax tree, or not the asked network's, is refused with the
reason (``tests/test_torch_checkpoint_msgpack.py`` reads the JAX
package's ``.msgpack`` files).
"""

import glob
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu_torch import (
    eval_depth, eval_odom, inference, run_inference, test_disp, test_pose, test_vo,
)
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import (
    load_torch_state_dict, pose_to_jax, save_torch_checkpoint, write_jax_variables,
)
from test_cli import REPO, H, W, _run, image_dir, odom_root  # noqa: F401 (fixtures)

CPU = ["--device", "cpu", "--precision", "fp32"]
PRED_RTOL = 1e-4        # network size
PRED_AREA_RTOL = 1e-3   # through an area shrink
TRAJ_TOL = 1e-4         # of max|ref|
DEPTH_METRIC_RTOL = 1e-4
ODOM_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(net, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.randn(c) * 0.1))
                m.running_var.copy_(torch.from_numpy(1.0 + rng.rand(c)))
                m.weight.copy_(torch.from_numpy(1.0 + rng.randn(c) * 0.1))
                m.bias.copy_(torch.from_numpy(rng.randn(c) * 0.1))
    return net


def _checkpoint(directory, net, name):
    path = str(directory / name)
    save_torch_checkpoint(net.state_dict(), path)
    return path


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's files go when it ends: a network's ``.pth.tar`` is 50-130
    MB, and pytest keeps the temporary directories of its last three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def disp_pth(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    net = DispNet(18, generator=torch.Generator().manual_seed(0))
    yield _checkpoint(d, _randomize_bn(net, 0), "dispnet_checkpoint.pth.tar")
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def pose_pth(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    net = PoseNet(18, generator=torch.Generator().manual_seed(1))
    yield _checkpoint(d, _randomize_bn(net, 1), "exp_pose_checkpoint.pth.tar")
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def depth_list(image_dir, tmp_path_factory):  # noqa: F811
    """The fixture's five 64x96 frames, then three 100x150 frames that
    shrink to the network size."""
    d = tmp_path_factory.mktemp("big")
    rng = np.random.RandomState(5)
    big = []
    for i in range(3):
        big.append(str(d / f"{i:06d}.png"))
        imageio.imwrite(big[-1], (rng.rand(100, 150, 3) * 255).astype(np.uint8))
    path = d / "list.txt"
    path.write_text("\n".join(sorted(glob.glob(os.path.join(image_dir, "*.png"))) + big) + "\n")
    return str(path)


def _disp_args(ckpt, depth_list, out, layers=18):
    return ["--pretrained-dispnet", ckpt, "--img-height", str(H), "--img-width", str(W),
            "--dataset-list", depth_list, "--output-dir", str(out),
            "--resnet-layers", str(layers), "--batch-size", "3"]


def _max_rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _of_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_preds(disp_pth, depth_list, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_preds")
    _run([sys.executable, "test_disp.py"] + _disp_args(disp_pth, depth_list, out))
    return np.load(out / "predictions.npy")


def test_test_disp_equals_jax(disp_pth, depth_list, jax_preds, tmp_path, capsys):
    assert test_disp.main(_disp_args(disp_pth, depth_list, tmp_path) + CPU) == 0
    preds = np.load(tmp_path / "predictions.npy")
    assert preds.shape == jax_preds.shape == (8, H, W)
    assert _max_rel(preds[:5], jax_preds[:5]) <= PRED_RTOL
    assert _max_rel(preds[5:], jax_preds[5:]) <= PRED_AREA_RTOL
    out = capsys.readouterr().out
    assert "8 files to test" in out and "Avg Time" in out and "Avg Speed" in out


def test_test_disp_resnet50_equals_jax(depth_list, tmp_path):
    net = _randomize_bn(DispNet(50, generator=torch.Generator().manual_seed(2)), 2)
    ckpt = _checkpoint(tmp_path, net, "dispnet50.pth.tar")
    _run([sys.executable, "test_disp.py"] + _disp_args(ckpt, depth_list, tmp_path / "jax", 50))
    assert test_disp.main(_disp_args(ckpt, depth_list, tmp_path / "port", 50) + CPU) == 0
    got, want = (np.load(tmp_path / d / "predictions.npy") for d in ("port", "jax"))
    assert _max_rel(got[:5], want[:5]) <= PRED_RTOL
    assert _max_rel(got[5:], want[5:]) <= PRED_AREA_RTOL


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _table(stdout):
    """The numbers of eval_depth's printed metric row."""
    row = [ln for ln in stdout.splitlines() if ln.startswith("&")][-1]
    return np.array([float(v) for v in re.findall(r"-?\d+\.\d+", row)])


@pytest.fixture(scope="module")
def gt_set(tmp_path_factory):
    """Ground truth at 100x150 (sparse, with invalid zeros) and frames of
    the same size for the visualizations."""
    d = tmp_path_factory.mktemp("gt")
    rng = np.random.RandomState(6)
    (d / "kitti").mkdir()
    (d / "imgs").mkdir()
    nyu = []
    for i in range(8):
        depth = (1 + rng.rand(100, 150) * 60).astype(np.float32)
        depth[rng.rand(100, 150) < 0.3] = 0
        np.save(d / "kitti" / f"{i:06d}.npy", depth)
        nyu.append((0.5 + rng.rand(100, 150) * 9).astype(np.float32))
        imageio.imwrite(d / "imgs" / f"{i:06d}.png", (rng.rand(100, 150, 3) * 255).astype(np.uint8))
    np.save(d / "nyu.npy", np.stack(nyu))
    return d


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
def test_eval_depth_equals_jax(dataset, gt_set, jax_preds, tmp_path, capsys):
    pred = tmp_path / "predictions.npy"
    np.save(pred, jax_preds)
    gt = str(gt_set / "kitti") if dataset == "kitti" else str(gt_set / "nyu.npy")
    args = ["--dataset", dataset, "--pred_depth", str(pred), "--gt_depth", gt,
            "--img_dir", str(gt_set / "imgs")]
    res = _run([sys.executable, "eval_depth.py", *args, "--vis_dir", str(tmp_path / "jax"),
                "--ratio_name", str(tmp_path / "jax_ratios.txt")])
    assert eval_depth.main(args + ["--vis_dir", str(tmp_path / "port"),
                                   "--ratio_name", str(tmp_path / "port_ratios.txt")]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-2:] == res.stdout.splitlines()[-2:]
    assert np.abs(_table(out) - _table(res.stdout)).max() <= 1e-3  # as printed
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port_ratios.txt"),
                               np.loadtxt(tmp_path / "jax_ratios.txt"), atol=1e-4)

    gts = (np.load(gt) if dataset == "nyu"
           else [np.load(f) for f in sorted(glob.glob(os.path.join(gt, "*.npy")))])
    want, want_resized = _load_root_module("eval_depth").evaluate_depth(gts, jax_preds, dataset)
    got, got_resized = eval_depth.evaluate_depth(gts, jax_preds, dataset)
    assert got.shape == want.shape == ((6,) if dataset == "nyu" else (7,))
    assert _max_rel(got, want) <= DEPTH_METRIC_RTOL
    for g, w in zip(got_resized, want_resized):
        assert _max_rel(g, w) <= DEPTH_METRIC_RTOL

    # The visualizations: the frames exactly; the magma maps up to a flip to
    # the neighbouring entry of the table (<= 3 grey levels, the table's
    # largest step as uint8) where the prediction differs in its last bits.
    names = sorted(os.listdir(tmp_path / "jax" / "vis_depth"))
    assert names == sorted(os.listdir(tmp_path / "port" / "vis_depth")) and len(names) == 8
    for name in names:
        a, b = (imageio.imread(tmp_path / d / "vis_depth" / name).astype(int)
                for d in ("port", "jax"))
        assert a.shape == b.shape == ((200, 150, 3) if dataset == "kitti" else (100, 450, 3))
        img = (slice(0, 100), slice(None)) if dataset == "kitti" else (slice(None), slice(0, 150))
        np.testing.assert_array_equal(a[img], b[img])
        diff = np.abs(a - b).max(axis=-1)
        assert diff.max() <= 3 and (diff > 0).mean() < 0.01, (name, diff.max(), (diff > 0).mean())


def test_run_inference_equals_jax(disp_pth, image_dir, tmp_path):  # noqa: F811
    args = ["--pretrained", disp_pth, "--output-disp", "--output-depth",
            "--img-height", str(H), "--img-width", str(W), "--dataset-dir", image_dir,
            "--resnet-layers", "18", "--batch-size", "2"]
    _run([sys.executable, "run_inference.py", *args, "--output-dir", str(tmp_path / "jax")])
    assert run_inference.main(args + ["--output-dir", str(tmp_path / "port")] + CPU) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 10
    for name in names:
        a, b = (imageio.imread(tmp_path / d / name).astype(int) for d in ("port", "jax"))
        assert a.shape == b.shape == (H, W, 3) and np.abs(a - b).max() <= 1, name
    assert run_inference.main(args[:2] + args[4:]) == 1  # no output asked


def test_test_vo_and_eval_odom_equal_jax(pose_pth, odom_root, tmp_path, capsys):  # noqa: F811
    args = ["--pretrained-posenet", pose_pth, "--img-height", str(H), "--img-width", str(W),
            "--dataset-dir", os.path.join(odom_root, "sequences") + os.sep, "--sequence", "09",
            "--batch-size", "3"]
    _run([sys.executable, "test_vo.py", *args, "--output-dir", str(tmp_path / "jax")])
    assert test_vo.main(args + ["--output-dir", str(tmp_path / "port")] + CPU) == 0
    got, want = (np.loadtxt(tmp_path / d / "09.txt") for d in ("port", "jax"))
    assert got.shape == want.shape == (8, 12)
    assert _of_max(got, want) <= TRAJ_TOL
    assert open(tmp_path / "port" / "09.txt").read().split()[0] == "1.00000000e+00"

    # eval_odom on the same trajectory, one copy each
    for d in ("jax_eval", "port_eval"):
        (tmp_path / d).mkdir()
        shutil.copy(tmp_path / "port" / "09.txt", tmp_path / d / "09.txt")
    odom_args = ["--gt_dir", os.path.join(odom_root, "poses"), "--align", "7dof", "--seqs", "9",
                 "--no-confirm", "--no-plot"]
    res = _run([sys.executable, "kitti_eval/eval_odom.py", "--result", str(tmp_path / "jax_eval"),
                *odom_args])
    capsys.readouterr()
    assert eval_odom.main(["--result", str(tmp_path / "port_eval")] + odom_args) == 0
    assert capsys.readouterr().out == res.stdout
    for rel in ("result.txt", os.path.join("errors", "09.txt")):
        a, b = (open(tmp_path / d / rel).read() for d in ("port_eval", "jax_eval"))
        nums_a, nums_b = (np.array([float(v) for v in re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", t)])
                          for t in (a, b))
        assert nums_a.shape == nums_b.shape
        assert np.all(np.abs(nums_a - nums_b) <= ODOM_RTOL * np.maximum(1.0, np.abs(nums_b)))


def test_eval_odom_defaults_to_the_shipped_gt(tmp_path, monkeypatch):
    assert eval_odom.build_parser().parse_args(["--result", "x"]).gt_dir == os.path.join(
        REPO, "kitti_eval", "gt_poses")
    shutil.copy(os.path.join(REPO, "kitti_eval", "gt_poses", "04.txt"), tmp_path / "04.txt")
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert eval_odom.main(["--result", str(tmp_path)]) == 1  # declined
    assert eval_odom.main(["--result", str(tmp_path), "--align", "7dof", "--no-confirm",
                           "--no-plot"]) == 0
    text = (tmp_path / "result.txt").read_text()
    assert "Trans. err. (%): \t 0.000" in text and "ATE (m): \t 0.000" in text


def test_test_pose_equals_jax(pose_pth, odom_root, tmp_path, capsys):  # noqa: F811
    args = [pose_pth, "--img-height", str(H), "--img-width", str(W), "--dataset-dir", odom_root,
            "--sequences", "09"]
    res = _run([sys.executable, "test_pose.py", *args, "--output-dir", str(tmp_path / "jax")])
    assert test_pose.main(args + ["--output-dir", str(tmp_path / "port")] + CPU) == 0
    out = capsys.readouterr().out
    got, want = (np.load(tmp_path / d / "predictions.npy") for d in ("port", "jax"))
    assert got.shape == want.shape == (4, 5, 3, 4)
    assert _of_max(got, want) <= TRAJ_TOL
    root = _load_root_module("test_pose")
    snips = list(root.snippets(odom_root, ["09"], 5))
    got_err = np.array([test_pose.compute_pose_error(s["poses"], p) for s, p in zip(snips, got)])
    want_err = np.array([root.compute_pose_error(s["poses"], p) for s, p in zip(snips, want)])
    assert _of_max(got_err, want_err) <= TRAJ_TOL
    for text in (out, res.stdout):
        assert "4 snippets to test" in text
        mean = [ln for ln in text.splitlines() if ln.startswith("mean")][0]
        assert np.isfinite([float(v) for v in re.findall(r"-?\d+\.\d+", mean)]).all()


NETWORK_CLIS = {
    "test_disp": (test_disp, ["--pretrained-dispnet", "x.pth.tar", "--output-dir", "o",
                              "--resnet-layers", "18"]),
    "run_inference": (run_inference, ["--pretrained", "x.pth.tar", "--output-disp",
                                      "--resnet-layers", "18"]),
    "test_pose": (test_pose, ["x.pth.tar"]),
    "test_vo": (test_vo, ["--pretrained-posenet", "x.pth.tar"]),
}


@pytest.mark.parametrize("name", sorted(NETWORK_CLIS))
def test_default_device_needs_a_card(name, monkeypatch, tmp_path):
    module, argv = NETWORK_CLIS[name]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device"):
        module.main(argv)


@pytest.mark.parametrize("name", ["test_disp", "eval_depth", "run_inference", "test_pose",
                                  "test_vo", "eval_odom"])
def test_cli_help(name):
    res = subprocess.run([sys.executable, "-m", f"sc_sfmlearner_release_tpu_torch.{name}",
                          "--help"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage:")


def test_msgpack_checkpoints_are_refused(pose_pth, tmp_path):
    garbage = tmp_path / "dispnet_checkpoint.msgpack"
    garbage.write_bytes(b"\x81\xa6params\xc1")
    for restore in (inference.restore_disp_state, inference.restore_pose_state):
        with pytest.raises(ValueError, match="unknown type byte 0xc1 at byte 8"):
            restore(str(garbage))
    pose_mp = str(tmp_path / "exp_pose_checkpoint.msgpack")
    write_jax_variables(pose_mp, pose_to_jax(load_torch_state_dict(pose_pth)))
    with pytest.raises(ValueError, match="not the flax variables of a ResNet-18 DispNet"):
        inference.restore_disp_state(pose_mp)
