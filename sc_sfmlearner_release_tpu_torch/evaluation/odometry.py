"""KITTI odometry benchmark evaluator.

The port's own numpy copy of the JAX package's ``evaluation/odometry.py``
(which the port does not import): the KITTI devkit's protocol, per-length
(100..800 m) translation / rotation errors sampled every 10 frames, ATE
(RMSE of aligned positions), RPE (mean frame-to-frame error), optional
trajectory alignment (scale / 6-DoF / 7-DoF Umeyama), PDF trajectory and
error plots, and a ``result.txt`` summary. matplotlib is imported only by
the plot methods.

Pose files are KITTI format: one ``3x4`` row-major pose per line (world
coordinates of each frame), optionally prefixed by a frame index.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
STEP_SIZE = 10  # segment start stride, frames
FRAME_PERIOD_S = 0.1  # KITTI is 10 FPS


def load_poses_txt(path: str) -> Dict[int, np.ndarray]:
    """Load ``{frame_idx: 4x4 pose}`` from a KITTI-format txt."""
    poses: Dict[int, np.ndarray] = {}
    with open(path) as f:
        for cnt, line in enumerate(f):
            vals = [float(v) for v in line.split()]
            if not vals:
                continue
            with_idx = len(vals) == 13
            p = np.eye(4)
            p[:3, :4] = np.asarray(vals[1:] if with_idx else vals).reshape(3, 4)
            poses[int(vals[0]) if with_idx else cnt] = p
    return poses


def scale_lse_solver(x: np.ndarray, y: np.ndarray) -> float:
    """Least-squares scale s minimizing ||s*x - y||."""
    return float(np.sum(x * y) / np.sum(x * x))


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Umeyama 1991 Sim(m) alignment of point sets ``x -> y`` (m x n)."""
    if x.shape != y.shape:
        raise ValueError("point sets must have identical shapes")
    m, n = x.shape

    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    xc = x - mean_x[:, None]
    yc = y - mean_y[:, None]

    sigma_x = float(np.sum(xc * xc)) / n
    cov = (yc @ xc.T) / n

    u, d, v = np.linalg.svd(cov)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[-1, -1] = -1.0

    r = u @ s @ v
    c = float(np.trace(np.diag(d) @ s) / sigma_x) if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def _rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def _translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


class KittiOdomEvaluator:
    """Full-sequence odometry evaluation with the devkit's protocol."""

    def __init__(self, lengths: Sequence[int] = LENGTHS):
        self.lengths = tuple(lengths)

    # -- core metrics --------------------------------------------------

    def trajectory_distances(self, poses: Dict[int, np.ndarray]) -> List[float]:
        idxs = sorted(poses)
        xyz = np.stack([poses[i][:3, 3] for i in idxs])
        step = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
        return [0.0] + list(np.cumsum(step))

    def calc_sequence_errors(
        self, poses_gt: Dict[int, np.ndarray], poses_result: Dict[int, np.ndarray]
    ) -> List[List[float]]:
        """[[first_frame, r_err/len, t_err/len, len, speed], ...] over all
        (start, length) segments."""
        err: List[List[float]] = []
        dist = self.trajectory_distances(poses_gt)
        for first in range(0, len(poses_gt), STEP_SIZE):
            for length in self.lengths:
                last = self._last_frame(dist, first, length)
                if last < 0 or last not in poses_result or first not in poses_result:
                    continue
                delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
                delta_pred = np.linalg.inv(poses_result[first]) @ poses_result[last]
                pose_error = np.linalg.inv(delta_pred) @ delta_gt
                num_frames = last - first + 1.0
                speed = length / (FRAME_PERIOD_S * num_frames)
                err.append(
                    [
                        first,
                        _rotation_error(pose_error) / length,
                        _translation_error(pose_error) / length,
                        length,
                        speed,
                    ]
                )
        return err

    @staticmethod
    def _last_frame(dist: List[float], first: int, length: float) -> int:
        target = dist[first] + length
        arr = np.asarray(dist[first:])
        hits = np.nonzero(arr > target)[0]
        return int(hits[0]) + first if len(hits) else -1

    def compute_segment_error(self, seq_errs) -> Dict[int, List[float]]:
        avg: Dict[int, List[float]] = {}
        for length in self.lengths:
            rows = [(e[2], e[1]) for e in seq_errs if e[3] == length]
            avg[length] = (
                [float(np.mean([r[0] for r in rows])),
                 float(np.mean([r[1] for r in rows]))]
                if rows else []
            )
        return avg

    def compute_overall_err(self, seq_err) -> Tuple[float, float]:
        if not seq_err:
            return 0.0, 0.0
        arr = np.asarray(seq_err)
        return float(arr[:, 2].mean()), float(arr[:, 1].mean())

    def compute_ATE(self, gt, pred) -> float:
        errs = [
            np.linalg.norm(gt[i][:3, 3] - pred[i][:3, 3]) ** 2 for i in pred
        ]
        return float(np.sqrt(np.mean(errs)))

    def compute_RPE(self, gt, pred) -> Tuple[float, float]:
        t_errs, r_errs = [], []
        for i in list(pred.keys())[:-1]:
            gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
            pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
            rel_err = np.linalg.inv(gt_rel) @ pred_rel
            t_errs.append(_translation_error(rel_err))
            r_errs.append(_rotation_error(rel_err))
        return float(np.mean(t_errs)), float(np.mean(r_errs))

    # -- alignment ------------------------------------------------------

    def scale_optimization(self, gt, pred):
        xyz_pred = np.stack([pred[i][:3, 3] for i in pred])
        xyz_gt = np.stack([gt[i][:3, 3] for i in pred])
        scale = scale_lse_solver(xyz_pred, xyz_gt)
        out = {i: pred[i].copy() for i in pred}
        for i in out:
            out[i][:3, 3] *= scale
        return out

    def align(self, poses_gt, poses_result, alignment: Optional[str]):
        """First-frame alignment always; then the requested optimization."""
        idx0 = sorted(poses_result)[0]
        pred0_inv = np.linalg.inv(poses_result[idx0])
        gt0_inv = np.linalg.inv(poses_gt[idx0])
        poses_result = {i: pred0_inv @ p for i, p in poses_result.items()}
        poses_gt = {i: gt0_inv @ p for i, p in poses_gt.items()}

        if alignment == "scale":
            poses_result = self.scale_optimization(poses_gt, poses_result)
        elif alignment in ("scale_7dof", "7dof", "6dof"):
            keys = list(poses_result)
            xyz_result = np.stack([poses_result[i][:3, 3] for i in keys]).T
            xyz_gt = np.stack([poses_gt[i][:3, 3] for i in keys]).T
            r, t, scale = umeyama_alignment(
                xyz_result, xyz_gt, alignment != "6dof"
            )
            align_tf = np.eye(4)
            align_tf[:3, :3] = r
            align_tf[:3, 3] = t
            for i in keys:
                poses_result[i] = poses_result[i].copy()
                poses_result[i][:3, 3] *= scale
                if alignment in ("7dof", "6dof"):
                    poses_result[i] = align_tf @ poses_result[i]
        return poses_gt, poses_result

    # -- top level --------------------------------------------------------

    def eval(
        self,
        gt_dir: str,
        result_dir: str,
        alignment: Optional[str] = None,
        seqs: Optional[Sequence[int]] = None,
        plot: bool = True,
    ) -> Dict[str, Dict[str, float]]:
        """Evaluate sequences; writes errors/, plot_path/, plot_error/,
        result.txt under ``result_dir`` and returns per-seq metrics."""
        error_dir = os.path.join(result_dir, "errors")
        plot_path_dir = os.path.join(result_dir, "plot_path")
        plot_error_dir = os.path.join(result_dir, "plot_error")
        for d in (error_dir, plot_path_dir, plot_error_dir):
            os.makedirs(d, exist_ok=True)

        if seqs is None:
            available = sorted(glob.glob(os.path.join(result_dir, "*.txt")))
            seqs = [
                int(os.path.basename(p)[:-4])
                for p in available
                if os.path.basename(p)[:-4].isdigit()
            ]

        results: Dict[str, Dict[str, float]] = {}
        summary_lines: List[str] = []
        copy_lines: List[str] = []

        for seq in seqs:
            name = f"{seq:02d}"
            poses_result = load_poses_txt(os.path.join(result_dir, f"{name}.txt"))
            poses_gt = load_poses_txt(os.path.join(gt_dir, f"{name}.txt"))
            poses_gt, poses_result = self.align(poses_gt, poses_result, alignment)

            seq_err = self.calc_sequence_errors(poses_gt, poses_result)
            with open(os.path.join(error_dir, f"{name}.txt"), "w") as f:
                for row in seq_err:
                    f.write(" ".join(str(v) for v in row) + "\n")

            avg_segment = self.compute_segment_error(seq_err)
            ave_t, ave_r = self.compute_overall_err(seq_err)
            ate = self.compute_ATE(poses_gt, poses_result)
            rpe_t, rpe_r = self.compute_RPE(poses_gt, poses_result)

            print(f"Sequence: {seq}")
            print("Translational error (%): ", ave_t * 100)
            print("Rotational error (deg/100m): ", ave_r / np.pi * 180 * 100)
            print("ATE (m): ", ate)
            print("RPE (m): ", rpe_t)
            print("RPE (deg): ", rpe_r * 180 / np.pi)

            if plot:
                self._plot_trajectory(poses_gt, poses_result, seq, plot_path_dir)
                self._plot_error(avg_segment, seq, plot_error_dir)

            results[name] = {
                "t_err_pct": ave_t * 100,
                "r_err_deg_per_100m": ave_r / np.pi * 180 * 100,
                "ate_m": ate,
                "rpe_m": rpe_t,
                "rpe_deg": rpe_r * 180 / np.pi,
            }
            summary_lines += [
                f"Sequence: \t {seq} \n",
                f"Trans. err. (%): \t {ave_t * 100:.3f} \n",
                f"Rot. err. (deg/100m): \t {ave_r / np.pi * 180 * 100:.3f} \n",
                f"ATE (m): \t {ate:.3f} \n",
                f"RPE (m): \t {rpe_t:.3f} \n",
                f"RPE (deg): \t {rpe_r * 180 / np.pi:.3f} \n\n",
            ]
            copy_lines += [f"{ave_t * 100:.2f}", f"{ave_r / np.pi * 180 * 100:.2f}"]

        with open(os.path.join(result_dir, "result.txt"), "w") as f:
            f.writelines(summary_lines)

        print("-------------------- For Copying ------------------------------")
        for line in copy_lines:
            print(line)
        return results

    # -- plotting -----------------------------------------------------------

    def _plot_trajectory(self, poses_gt, poses_result, seq, out_dir):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig = plt.figure()
        ax = plt.gca()
        ax.set_aspect("equal")
        idxs = sorted(poses_result)
        for label, poses in (("Ground Truth", poses_gt), ("Ours", poses_result)):
            xz = np.asarray([[poses[i][0, 3], poses[i][2, 3]] for i in idxs])
            plt.plot(xz[:, 0], xz[:, 1], label=label)
        plt.legend(loc="upper right", prop={"size": 20})
        plt.xlabel("x (m)", fontsize=20)
        plt.ylabel("z (m)", fontsize=20)
        fig.set_size_inches(10, 10)
        plt.savefig(
            os.path.join(out_dir, f"sequence_{seq:02d}.pdf"),
            bbox_inches="tight", pad_inches=0,
        )
        plt.close(fig)

    def _plot_error(self, avg_segment_errs, seq, out_dir):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        for idx, (ylabel, fname, scale) in enumerate(
            (
                ("Translation Error (%)", f"trans_err_{seq:02d}.pdf", 100.0),
                ("Rotation Error (deg/100m)", f"rot_err_{seq:02d}.pdf",
                 180.0 / np.pi * 100.0),
            )
        ):
            xs, ys = [], []
            for length in self.lengths:
                xs.append(length)
                v = avg_segment_errs[length]
                ys.append(v[idx] * scale if v else 0.0)
            fig = plt.figure()
            plt.plot(xs, ys, "bs-", label=ylabel.split(" (")[0])
            plt.ylabel(ylabel, fontsize=10)
            plt.xlabel("Path Length (m)", fontsize=10)
            plt.legend(loc="upper right", prop={"size": 10})
            fig.set_size_inches(5, 5)
            plt.savefig(os.path.join(out_dir, fname), bbox_inches="tight",
                        pad_inches=0)
            plt.close(fig)
