"""How many pixels of each discrete decision of ManyDepth's step flip
between the program and the reference, and between the reference at
bf16 and at fp32, on the first batch of a run of the cell
``manydepth_r18_kitti.packed`` from a seed: the cost volume's lowest-cost
bin and its confidence mask (1/4 resolution), the consistency mask and the
teacher's minimum-reprojection (auto-)mask at each scale (full size). Both
sides start from the seed's weights and see the same batch and draws.

    python3 -m benchmark.families.manydepth.flips --seeds N [N ...] [--isolate]

Prints one JSON line a seed. ``--isolate`` adds a line a seed that finds
which input of the cost volume makes its lowest-cost bin differ: the
public loop on the bf16 reference's own inputs against the kernel on
them, and against the loop with one of them taken from the program
(bins, inverse intrinsics, matching pose, features; the features also
computed by the program's network from the reference's frames), and the
reference's float32 features against both sides' bf16 ones. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import dataset, follow, spec
from benchmark.weights import init_weights

CELL = "manydepth_r18_kitti.packed"


def _share(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.reshape(-1), b.reshape(-1)
    n = int((a != b).sum())
    return {"flipped": n, "pixels": a.numel(), "share": n / a.numel()}


def decisions(out: dict) -> dict:
    keys = ["lowest_cost", "confidence", "consistency"] + [("automask", s) for s in range(4)]
    return {k if isinstance(k, str) else f"automask_{k[1]}": out[k].float() for k in keys}


def program_decisions(cfg: dict, seed: int, batch, device) -> dict:
    from sc_sfmlearner_release_tpu_torch.data.device_augment import (AugmentConfig,
                                                                     make_device_augment,
                                                                     resize_nchw,
                                                                     step_generator)
    from sc_sfmlearner_release_tpu_torch.models.manydepth import ManyDepth
    from sc_sfmlearner_release_tpu_torch.training import manydepth as md

    model = ManyDepth(cfg["num_layers"], cfg["num_depth_bins"]).to(device)
    init_weights({"mono": model.mono, "multi": model.multi, "pose": model.pose}, seed, device)
    tgt, refs, k = batch
    b, _, h, w = tgt.shape
    aug = md.MatchingAugment(make_device_augment(AugmentConfig()), cfg["height"], cfg["width"])
    packed = aug.host_map(step_generator(seed, 0), b, h, w).to(device)
    n = aug.augment.map_width(h, w)
    snippet = resize_nchw({"tgt": tgt.permute(0, 2, 3, 1), "refs": refs.permute(0, 1, 3, 4, 2),
                           "intrinsics": k}, cfg["height"], cfg["width"])
    snippet.update(match_u=packed[:, n], noise_key=packed[0, n + 1:])
    step_cfg = md.ManyDepthConfig(height=cfg["height"], width=cfg["width"],
                                  num_depth_bins=cfg["num_depth_bins"])
    record = {}
    with torch.no_grad():
        md.manydepth_loss(model, snippet, md.make_trackers(step_cfg, device), step_cfg,
                          cfg["precision"], record=record)
    record = {k: v[:, 0] if k == "consistency" else v for k, v in record.items()}
    return decisions(record)


def _lowest(volume: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """The reference's lowest-cost disparity of an unmasked volume."""
    viz = torch.where(volume == 0, torch.full_like(volume, 100.0), volume)
    return 1 / bins[viz.argmin(1)]


def _bin_flips(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Pixels whose lowest-cost disparities differ by more than 0.1%
    (neighbouring bins lie 1% apart or more), so that the two bin sets'
    rounding alone counts none."""
    n = int(((a - b).abs() > 1e-3 * b.abs()).sum())
    return {"flipped": n, "pixels": a.numel(), "share": n / a.numel()}


def _reference_inputs(cfg: dict, seed: int, batch, device, precision: str):
    """The arguments the reference's step hands ``match_features`` (cur,
    lookup, poses, k, inv_k, bins) on ``batch``, and its resized frames."""
    ref = spec.family("manydepth", "reference")
    seen = {}
    real = ref.match_features

    def capture(*args):
        seen["args"] = args
        return real(*args)

    ref.match_features = capture
    try:
        with torch.no_grad():
            ref.Step(cfg, device, precision, seed).forward(batch)
    finally:
        ref.match_features = real
    tgt, refs, _ = batch
    b = tgt.shape[0]
    frames = torch.cat([tgt[:, None], refs], 1).flatten(0, 1)
    frames = torch.nn.functional.interpolate(frames, size=(cfg["height"], cfg["width"]),
                                             mode="bilinear", align_corners=False)
    return seen["args"], frames.view(b, 3, 3, cfg["height"], cfg["width"])


def isolate(cfg: dict, seed: int, batch, device) -> dict:
    """Lowest-cost flips against the bf16 reference's, one input swapped at
    a time (see the module's docstring)."""
    from sc_sfmlearner_release_tpu_torch.data.device_augment import (AugmentConfig,
                                                                     make_device_augment,
                                                                     resize_nchw,
                                                                     step_generator)
    from sc_sfmlearner_release_tpu_torch.models.manydepth import ManyDepth
    from sc_sfmlearner_release_tpu_torch.ops.cost_volume import cost_volume, depth_bins
    from sc_sfmlearner_release_tpu_torch.ops.geometry import transformation_from_parameters
    from sc_sfmlearner_release_tpu_torch.training import manydepth as md
    from sc_sfmlearner_release_tpu_torch.training.step import conv_autocast

    ref = spec.family("manydepth", "reference")
    (cur, lookup, poses, k, inv_k, bins), ref_frames = _reference_inputs(cfg, seed, batch,
                                                                        device, "bf16")
    fp32 = _reference_inputs(cfg, seed, batch, device, "fp32")[0]

    def loop(cur=cur, lookup=lookup, poses=poses, k=k, inv_k=inv_k, bins=bins):
        return _lowest(ref.match_features(cur, lookup, poses, k, inv_k, bins)[0], bins)

    want = loop()
    model = ManyDepth(cfg["num_layers"], cfg["num_depth_bins"]).to(device)
    init_weights({"mono": model.mono, "multi": model.multi, "pose": model.pose}, seed, device)
    tgt, refs, k_raw = batch
    b, _, h, w = tgt.shape
    aug = md.MatchingAugment(make_device_augment(AugmentConfig()), cfg["height"], cfg["width"])
    packed = aug.host_map(step_generator(seed, 0), b, h, w).to(device)
    u = packed[:, aug.augment.map_width(h, w)]
    snippet = resize_nchw({"tgt": tgt.permute(0, 2, 3, 1), "refs": refs.permute(0, 1, 3, 4, 2),
                           "intrinsics": k_raw}, cfg["height"], cfg["width"])
    static = (u < md.STATIC_BELOW).view(b, 1, 1, 1)
    keep = ((u < md.STATIC_BELOW) | (u >= md.EMPTY_BELOW)).float().view(b, 1, 1)

    def features(tgt, prev):
        with conv_autocast(device, "bf16"):
            return (model.multi._early(tgt)[1].float(),
                    model.multi._early(torch.where(static, tgt, prev))[1].float())

    with torch.no_grad():
        model.train()
        port_cur, port_lookup = features(snippet["tgt"], snippet["refs"][:, 0])
        frame_cur, frame_lookup = features(ref_frames[:, 0], ref_frames[:, 1])
        with conv_autocast(device, "bf16"):
            pose = md._pose(model.pose, snippet["refs"][:, 0], snippet["tgt"])
        t_prev = transformation_from_parameters(pose[:, :3], pose[:, 3:], invert=True) * keep
        port_inv = torch.eye(4, device=device).repeat(b, 1, 1)
        port_inv[:, :3, :3] = md._inv_k(k[:, :3, :3])
        port_bins = depth_bins(torch.tensor(cfg["tracker_start"][0], device=device),
                               torch.tensor(cfg["tracker_start"][1], device=device),
                               cfg["num_depth_bins"])
        proj = (k @ poses)[:, :3]
        kernel = cost_volume(cur, lookup, proj, inv_k[:, :3, :3], bins)[1]
        k4 = md._scaled_k(snippet["intrinsics"], 0.25)
        program = cost_volume(port_cur, port_lookup, k4 @ t_prev[:, :3], md._inv_k(k4),
                              port_bins)[1]
        row = {"seed": seed, "lowest_cost_vs_bf16_loop": {
            "kernel": _bin_flips(kernel, want),
            "program_bins": _bin_flips(loop(bins=port_bins), want),
            "program_inv_k": _bin_flips(loop(inv_k=port_inv), want),
            "program_pose": _bin_flips(loop(poses=t_prev), want),
            "program_features": _bin_flips(loop(cur=port_cur, lookup=port_lookup), want),
            "program_network_on_reference_frames": _bin_flips(
                loop(cur=frame_cur, lookup=frame_lookup), want),
            "program_all_kernel": _bin_flips(program, want),
            "reference_fp32_features": _bin_flips(loop(cur=fp32[0], lookup=fp32[1]), want)}}
        fp32_want = loop(cur=fp32[0], lookup=fp32[1])
        row["lowest_cost_vs_fp32_features"] = {
            "reference_bf16": _bin_flips(want, fp32_want),
            "program_features": _bin_flips(loop(cur=port_cur, lookup=port_lookup), fp32_want)}
        row["feature_gap"] = {
            name: float((a - fp32[0]).abs().max() / fp32[0].abs().max())
            for name, a in (("reference_bf16", cur), ("program", port_cur),
                            ("program_network_on_reference_frames", frame_cur))}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--isolate", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flips needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.resolve(spec.load_benchmark(), CELL)
    cfg, traffic = cell.config, cell.traffic
    ref = spec.family("manydepth", "reference")
    for seed in args.seeds:
        batch = follow.Batches(cfg, traffic, seed, device, dataset.pool_files(traffic))(0)
        sides = {}
        for precision in ("bf16", "fp32"):
            with torch.no_grad():
                out = ref.Step(cfg, device, precision, seed).forward(batch)[1]
            sides[precision] = decisions(out)
        sides["program"] = program_decisions(cfg, seed, batch, device)
        row = {"seed": seed, "confident_share": float(sides["bf16"]["confidence"].mean())}
        for name in sides["bf16"]:
            # The two sides compute their bins apart (linspace in float64,
            # arange in float32): the same bin's disparity may differ in its
            # last bit, which is no flip.
            share = _bin_flips if name == "lowest_cost" else _share
            row[name] = {"program_vs_bf16": share(sides["program"][name], sides["bf16"][name]),
                         "bf16_vs_fp32": share(sides["bf16"][name], sides["fp32"][name])}
        print(json.dumps(row), flush=True)
        if args.isolate:
            print(json.dumps(isolate(cfg, seed, batch, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
