"""The port's odometry evaluator (``evaluation/odometry.py``, its own numpy
copy) against the JAX package's ``KittiOdomEvaluator``: the same
trajectories under every alignment, the shipped ``kitti_eval/gt_poses``
evaluated against themselves, and the helpers; equal within 1e-9."""

import os

import numpy as np
import pytest

from sc_sfmlearner_release_tpu import evaluation as jev
from sc_sfmlearner_release_tpu_torch import evaluation as pev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GT_DIR = os.path.join(REPO, "kitti_eval", "gt_poses")
TOL = 1e-9


def _trajectory(n, seed, noise):
    """A drive at ~1.5 m per frame with a slow yaw, as KITTI rows."""
    rng = np.random.RandomState(seed)
    rows, pose = [], np.eye(4)
    for _ in range(n):
        yaw = 0.01 + noise * rng.randn()
        step = np.eye(4)
        step[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        step[:3, 3] = [noise * rng.randn(), noise * rng.randn(), 1.5 + noise * rng.randn()]
        pose = pose @ step
        rows.append(pose[:3].reshape(-1))
    return np.stack(rows)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(b))), np.abs(a - b).max()


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


def _eval_both(tmp_path, gt_dir, result_rows, seqs, alignment, plot=False):
    out = {}
    for name, module in (("jax", jev), ("port", pev)):
        res = tmp_path / name
        res.mkdir()
        for seq, rows in zip(seqs, result_rows):
            np.savetxt(res / f"{seq:02d}.txt", rows, fmt="%.12e")
        out[name] = (module.KittiOdomEvaluator().eval(gt_dir, str(res), alignment=alignment,
                                                      seqs=seqs, plot=plot), str(res))
    return out


@pytest.mark.parametrize("alignment", [None, "scale", "scale_7dof", "7dof", "6dof"])
def test_evaluator_equals_jax(tmp_path, alignment):
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    np.savetxt(gt_dir / "09.txt", _trajectory(160, 0, 0.0), fmt="%.12e")
    pred = _trajectory(160, 1, 0.02) * np.tile([1, 1, 1, 0.8], 3)  # a scale drift
    out = _eval_both(tmp_path, str(gt_dir), [pred], [9], alignment)
    (jres, jdir), (pres, pdir) = out["jax"], out["port"]
    assert jres.keys() == pres.keys() == {"09"}
    for key in jres["09"]:
        _close(pres["09"][key], jres["09"][key])
    assert jres["09"]["t_err_pct"] > 0  # the 100-200 m segments exist
    jf, pf = _files(jdir), _files(pdir)
    assert jf.keys() == pf.keys()
    for rel in ("errors/09.txt", "result.txt"):
        assert open(pf[rel]).read() == open(jf[rel]).read()


@pytest.mark.parametrize("seq", [f"{s:02d}" for s in range(11)])
def test_shipped_gt_self_eval_equals_jax(tmp_path, seq):
    rows = np.loadtxt(os.path.join(GT_DIR, f"{seq}.txt"))
    out = _eval_both(tmp_path, GT_DIR, [rows], [int(seq)], "7dof")
    jres, pres = out["jax"][0][seq], out["port"][0][seq]
    for key in jres:
        _close(pres[key], jres[key])
    assert pres["t_err_pct"] < 1e-6 and pres["ate_m"] < 1e-6


def test_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 40)
    r = np.linalg.qr(rng.randn(3, 3))[0]
    y = 1.7 * r @ x + rng.randn(3, 1) + 1e-3 * rng.randn(3, 40)
    for with_scale in (False, True):
        for got, want in zip(pev.umeyama_alignment(x, y, with_scale),
                             jev.umeyama_alignment(x, y, with_scale)):
            _close(got, want)
    assert pev.scale_lse_solver(x, y) == jev.scale_lse_solver(x, y)
    path = tmp_path / "p.txt"
    rows = _trajectory(5, 4, 0.1)
    np.savetxt(path, np.concatenate([np.arange(5)[:, None] * 2, rows], axis=1))
    got, want = pev.load_poses_txt(str(path)), jev.load_poses_txt(str(path))
    assert list(got) == list(want) == [0, 2, 4, 6, 8]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_plots_are_written(tmp_path):
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    np.savetxt(gt_dir / "03.txt", _trajectory(90, 5, 0.0))
    out = _eval_both(tmp_path, str(gt_dir), [_trajectory(90, 6, 0.01)], [3], "scale", plot=True)
    assert _files(out["port"][1]).keys() == _files(out["jax"][1]).keys()
    assert {"plot_path/sequence_03.pdf", "plot_error/trans_err_03.pdf",
            "plot_error/rot_err_03.pdf"} <= _files(out["port"][1]).keys()
