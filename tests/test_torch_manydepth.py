"""ManyDepth's train step in the port (``training/manydepth.py``,
``models/manydepth.py``, ``ops/cost_volume.py``) against the benchmark's
plain reference (``benchmark/families/manydepth/reference.py``) on the CPU,
at B2, 64x128 frames and 8 depth bins, in float32, on seeded weights
(``benchmark/weights.py``, the same on both sides).

The pieces are compared one by one (the cost volume with its confidence and
lowest cost, each network, the pose transform, the draws and the tie
noise, the loss terms at each scale), then whole steps through the
benchmark's harness (the loss, every leaf's gradient after one step, the
updates, the trackers), a fused dispatch against eager steps (ManyDepth's
and SC-Depth's, through the one dispatch they share), and the
comparison must fail on a zeroed cost volume and on a wrong bin range.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import cell as harness
from benchmark import check, dataset, follow, spec
from benchmark.tests import tiny
from benchmark.weights import init_weights
from sc_sfmlearner_release_tpu_torch.data.device_augment import (AugmentConfig,
                                                                 make_device_augment,
                                                                 resize_nchw, step_generator)
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.manydepth import ManyDepth
from sc_sfmlearner_release_tpu_torch.ops import cost_volume as cv
from sc_sfmlearner_release_tpu_torch.ops import losses
from sc_sfmlearner_release_tpu_torch.ops.geometry import transformation_from_parameters
from sc_sfmlearner_release_tpu_torch.training import make_optimizer, make_train_step
from sc_sfmlearner_release_tpu_torch.training import manydepth as md

CELL = "manydepth_r18_kitti.packed"
H, W, BINS, B = 64, 128, 8, 2
SEED = 2 ** 31 + 21
ref = spec.family("manydepth", "reference")


def _cfg():
    cfg = json.loads(open(os.path.join(spec.ROOT, "benchmark", "configs",
                                       "manydepth_r18_kitti.json")).read())
    cfg.update(height=H, width=W, batch_size=B, fused_steps=2, num_depth_bins=BINS,
               precision="fp32")
    return cfg


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return tiny.tiny_pool(str(tmp_path_factory.mktemp("pool")))


@pytest.fixture(scope="module")
def tiny_cell(pool):
    """The cell at the tests' size, its scenes' intrinsics scaled from the
    pool's 832x256 to the tiny frames (both sides read them from
    ``Scene.matrix``), so the cost volume sees the geometry it would."""
    cell = spec.resolve(spec.load_benchmark(), CELL)
    cell.config.update(_cfg())
    cell.traffic.update(pool=pool, scenes=2, frames_per_scene=8, workers=2)
    matrix = dataset.Scene.matrix
    scale = np.array([[tiny.W / 832], [tiny.H / 256], [1.0]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dataset.Scene, "matrix", lambda self: matrix(self) * scale)
        yield cell


def _nets(seed=SEED):
    """The port's networks and the reference's, seeded alike."""
    torch.manual_seed(0)
    model = ManyDepth(18, BINS)
    init_weights({"mono": model.mono, "multi": model.multi, "pose": model.pose}, seed, "cpu")
    side = ref.Step(_cfg(), torch.device("cpu"), "fp32", seed)
    return model, side


def _frames(pool, n=3):
    raw = torch.from_numpy(tiny.frames(pool)[:n * B].astype(np.float32) / 255.0)
    return ((raw - 0.45) / 0.225).view(B, n, tiny.H, tiny.W, 3).permute(0, 1, 4, 2, 3)


# ---- the cost volume -----------------------------------------------------------

def _volume_inputs(kind):
    g = torch.Generator().manual_seed(5)
    h, w = H // 4, W // 4
    cur = F.avg_pool2d(torch.randn(B, 64, h, w, generator=g), 3, 1, 1)
    lookup = torch.roll(cur, 2, dims=3) + 0.05 * torch.randn(B, 64, h, w, generator=g)
    k3 = torch.tensor([[0.58 * w, 0.0, 0.5 * w], [0.0, 1.92 * h, 0.5 * h], [0.0, 0.0, 1.0]])
    k3 = k3.expand(B, 3, 3).clone()
    pose = torch.eye(4).repeat(B, 1, 1)
    if kind == "moving":
        pose[:, :3, 3] = torch.tensor([0.02, 0.0, -0.4])
    elif kind == "zero":
        pose[1] = 0.0
    bins = torch.linspace(0.1, 10.0, BINS)
    return cur, lookup, k3, pose, bins


@pytest.mark.parametrize("kind", ["moving", "zero", "static"])
def test_cost_volume_matches_the_public_loop(kind):
    cur, lookup, k3, pose, bins = _volume_inputs(kind)
    volume, lowest, confidence = cv.cost_volume(cur, lookup, k3 @ pose[:, :3],
                                                torch.linalg.inv(k3), bins)
    k4 = ref.k4(k3, 1.0)
    want, missing = ref.match_features(cur, lookup, pose, k4, torch.linalg.inv(k4), bins)
    want_conf = ((want * (1 - missing) > 0).sum(1) == BINS).float()
    viz = torch.where(want == 0, torch.full_like(want, 100.0), want)
    torch.testing.assert_close(confidence, want_conf, rtol=0, atol=0)
    torch.testing.assert_close(volume, want * want_conf[:, None], rtol=1e-5, atol=1e-6)
    assert (lowest != 1 / bins[viz.min(1)[1]]).float().mean() <= 1e-3
    if kind == "zero":
        assert confidence[1].sum() == 0 and volume[1].abs().sum() == 0
    if kind == "moving":
        assert 0.2 < float(confidence.mean()) < 1.0


def test_cost_volume_bins_are_linear_between_the_trackers():
    got = cv.depth_bins(torch.tensor(0.5), torch.tensor(12.0), BINS)
    torch.testing.assert_close(got, torch.from_numpy(np.linspace(0.5, 12.0, BINS)).float())


# ---- networks, poses, draws --------------------------------------------------

@pytest.mark.parametrize("net", ["mono", "multi", "pose"])
def test_networks_match_the_reference(pool, net):
    model, side = _nets()
    model.train()
    for n in side.nets.values():
        n.train()
    x = _frames(pool)[:, :, :, :H, :W]
    tgt, prev = x[:, 0].contiguous(), x[:, 1].contiguous()
    with torch.no_grad():
        if net == "mono":
            got, want = model.mono(tgt), side.nets["mono"](tgt)
        elif net == "pose":
            got = [md._pose(model.pose, prev, tgt)]
            aa, t = side.nets["pose"](torch.cat([prev, tgt], 1))
            want = [torch.cat([aa[:, 0, 0], t[:, 0, 0]], 1)]
        else:
            cur, lookup, k3, pose, bins = _volume_inputs("moving")
            k3 = k3 * 4
            k3[:, 2, 2] = 1
            proj = (md._scaled_k(k3, 0.25) @ pose[:, :3])
            got, lowest, conf = model.multi(tgt, prev, proj,
                                            md._inv_k(md._scaled_k(k3, 0.25)), bins)
            feats = side.nets["multi"].extract(tgt)
            k4 = ref.k4(k3, 0.25)
            vol, miss = ref.match_features(feats[1], side.nets["multi"].extract(prev)[1],
                                           pose, k4, torch.linalg.inv(k4), bins)
            c = ((vol * (1 - miss) > 0).sum(1) == BINS).float()
            y = F.relu(side.nets["multi"].reduce_conv(torch.cat([feats[1], vol * c[:, None]],
                                                                1)))
            e = side.nets["multi"].encoder.encoder
            for layer in (e.layer2, e.layer3, e.layer4):
                y = layer(y)
                feats.append(y)
            want = side.nets["multi"].decoder(feats)
            torch.testing.assert_close(conf, c, rtol=0, atol=0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("invert", [False, True])
def test_axis_angle_transform_matches_monodepth2(invert):
    g = torch.Generator().manual_seed(1)
    aa, t = 0.1 * torch.randn(4, 3, generator=g), torch.randn(4, 3, generator=g)
    got = transformation_from_parameters(aa, t, invert)
    want = ref.transformation_from_parameters(aa[:, None], t[:, None], invert)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_step_draws_and_tie_noise_are_the_references():
    aug = md.MatchingAugment(make_device_augment(AugmentConfig()), H, W)
    packed = aug.host_map(step_generator(SEED, 7), B, tiny.H, tiny.W)
    u, key = ref.step_draws(SEED, 7, B)
    n = tiny.H + tiny.W + 5
    assert packed[:, n].tolist() == u and packed[0, n + 1:].tolist() == [float(k) for k in key]
    got = md.tie_noise(packed[0, n + 1:], (4, B, 1, H, W))
    want = ref.tie_noise(key, (4, B, 1, H, W), "cpu")
    assert torch.equal(got, want)
    assert abs(float(got.std()) / md.NOISE - 1) < 0.05 and abs(float(got.mean())) < 1e-7


def test_resize_scales_the_intrinsics_with_the_frames(pool):
    x = _frames(pool).permute(0, 1, 3, 4, 2)
    k = torch.tensor([[100.0, 0, 60], [0, 90, 30], [0, 0, 1]]).expand(B, 3, 3)
    out = resize_nchw({"tgt": x[:, 0], "refs": x[:, 1:], "intrinsics": k}, 32, 96)
    assert out["tgt"].shape == (B, 3, 32, 96) and out["refs"].shape == (B, 2, 3, 32, 96)
    torch.testing.assert_close(out["intrinsics"][0], torch.tensor(
        [[100.0 * 96 / tiny.W, 0, 60 * 96 / tiny.W], [0, 90 * 32 / tiny.H, 30 * 32 / tiny.H],
         [0, 0, 1]]))


# ---- the loss terms at each scale ------------------------------------------------

@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_loss_terms_match_the_reference_at_each_scale(pool, scale):
    model, _ = _nets()
    x = _frames(pool)[:, :, :, :H, :W]
    target = x[:, 0] * 0.225 + 0.45
    with torch.no_grad():
        disp = model.mono(x[:, 0].contiguous())[scale]
    up = F.interpolate(disp, (H, W), mode="bilinear", align_corners=False)
    torch.testing.assert_close(losses.disp_to_depth(up, 0.1, 100.0)[1],
                               ref.disp_to_depth(up, 0.1, 100.0)[1])
    shifted = torch.roll(target, 1 + scale, dims=3)
    r = losses.reprojection_loss(shifted, target)
    # Two SSIM formulations (the port's 3x3 sums, the reference's avg_pool2d)
    # part by rounding where the windows are flat and the ratio ill-conditioned.
    torch.testing.assert_close(r, ref.reprojection(shifted, target), rtol=1e-3, atol=5e-5)
    ident = losses.reprojection_loss(x[:, 1] * 0.225 + 0.45, target)
    mask = losses.automask(r, ident)
    idx = torch.argmin(torch.cat([r, ident], 1), dim=1, keepdim=True)
    assert torch.equal(mask, (idx == 0).float())
    img = target if scale == 0 else F.avg_pool2d(target, 2 ** scale)
    norm = disp / (disp.mean(2, True).mean(3, True) + 1e-7)
    torch.testing.assert_close(losses.edge_aware_smoothness(norm, img),
                               ref.smooth_loss(norm, img))
    torch.testing.assert_close(losses.masked_mean(r, mask), (r * mask).sum() / (mask.sum() + 1e-7))


def test_total_and_path_losses_match_the_reference(pool):
    model, side = _nets()
    x = _frames(pool)
    k = torch.tensor([[0.58 * tiny.W, 0, 0.5 * tiny.W], [0, 1.92 * tiny.H, 0.5 * tiny.H],
                      [0, 0, 1]]).expand(B, 3, 3).clone()
    step = 0
    packed = md.MatchingAugment(make_device_augment(AugmentConfig()), H, W).host_map(
        step_generator(SEED, step), B, tiny.H, tiny.W)
    n = tiny.H + tiny.W + 5
    snippet = resize_nchw({"tgt": x[:, 0].permute(0, 2, 3, 1), "refs": x[:, 1:].permute(
        0, 1, 3, 4, 2), "intrinsics": k}, H, W)
    snippet.update(match_u=packed[:, n], noise_key=packed[0, n + 1:])
    trackers = md.make_trackers(md.ManyDepthConfig(), "cpu")
    cfg = md.ManyDepthConfig(height=H, width=W, num_depth_bins=BINS)
    total, metrics, new = md.manydepth_loss(model, snippet, trackers, cfg, "fp32")
    want, out = side.forward((x[:, 0], x[:, 1:], k))
    side.update_adaptive_depth_bins(out)
    torch.testing.assert_close(total, want, rtol=2e-5, atol=0)
    torch.testing.assert_close(metrics["mono_loss"], out["mono_loss"], rtol=2e-5, atol=0)
    torch.testing.assert_close(metrics["multi_loss"], out["multi_loss"], rtol=2e-5, atol=0)
    torch.testing.assert_close(new, side.trackers, rtol=1e-5, atol=0)
    torch.testing.assert_close(metrics["confident_pct"], out["confidence"].mean() * 100)


# ---- whole steps through the harness ---------------------------------------------

def _follow(cell, seed=SEED):
    cfg, traffic = cell.config, cell.traffic
    first = harness.run(cfg, traffic, seed, 0.0, False, torch.device("cpu"),
                        lambda s: None)["first"]
    want = follow.follow(cfg, traffic, seed, harness.CHECKED_STEPS, "cpu", precision="fp32")
    want["replay"] = follow.follow_from(cfg, traffic, seed, first["replay"], "cpu",
                                        precision="fp32")
    return first, want


@pytest.fixture(scope="module")
def sound(tiny_cell):
    first, want = _follow(tiny_cell)
    return first, want, check.numbers(first, want)


# At 64x128 one pixel is 1.2e-4 of a masked mean: the losses part where a
# decision (an auto-mask, a lowest-cost bin, a consistency pixel) flips on
# rounding between the two SSIM formulations and the two cost volumes.
SOUND = {"loss1_rel": 2e-4, "grad1_median_rel": 1e-4, "grad1_rel": 2e-2, "update_rel": 2e-2,
         "update_median_rel": 5e-3, "replay_loss1_rel": 2e-4, "replay_update_rel": 5e-3,
         "replay_update_median_rel": 5e-4}
# The numbers the cell compares (its limits file's), at the tests' size.
COMPARED = {n: SOUND[n] for n in spec.resolve(spec.load_benchmark(), CELL).limits["limits"]}
# A seed whose first batches keep confident pixels, so that the cost volume
# reaches the loss from the first step (the tests' SEED keeps none there).
FAULT_SEED = 2 ** 31 + 53


@pytest.mark.parametrize("number", sorted(SOUND))
def test_program_follows_the_reference(sound, number):
    assert sound[2][number] <= SOUND[number], sound[2]


def test_every_leaf_gradient_after_one_step(sound):
    first, want, _ = sound
    leaves = [n for n in want["grad1"] if not n.startswith(("draws.", "depth_bins."))]
    assert len(leaves) == 246 and set(first["grad1"]) == set(want["grad1"])
    gaps = check.leaf_gaps(first["grad1"], want["grad1"], leaves)
    assert max(gaps.values()) <= SOUND["grad1_rel"], sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    assert all(want["grad1"][n] > 0 for n in leaves)


def test_trackers_follow_the_reference_over_three_steps_and_the_replay(sound):
    first, want, _ = sound
    for side in ("update",):
        got, exp = first[side]["depth_bins.trackers"], want[side]["depth_bins.trackers"]
        assert exp > 1e-3 and abs(got - exp) <= 1e-4 * exp
    got = first["replay"]["update"]["depth_bins.trackers"]
    exp = want["replay"]["update"]["depth_bins.trackers"]
    assert abs(got - exp) <= 1e-4 * exp
    assert first["replay"]["update"]["draws.seed"] == 0.0


def _train_step(arch, k):
    """(step, networks) of ``arch``'s train step on the CPU in fp32 with
    ``fused_steps=k``, seeded alike on every call: ManyDepth's at the tests'
    size, or SC-Depth's (DispNet-18, PoseNet-18) on the raw frames, both
    through the device augmentation with seed 11."""
    augment = make_device_augment(AugmentConfig())
    if arch == "sc_depth":
        disp = DispNet(18, generator=torch.Generator().manual_seed(0))
        pose = PoseNet(18, generator=torch.Generator().manual_seed(1))
        step = make_train_step(disp, pose, make_optimizer(disp, pose), device="cpu",
                               precision="fp32", augment_fn=augment, aug_seed=11,
                               fused_steps=k)
        return step, torch.nn.ModuleList([disp, pose])
    model, _ = _nets()
    cfg = md.ManyDepthConfig(height=H, width=W, num_depth_bins=BINS)
    step = md.make_manydepth_train_step(model, md.make_manydepth_optimizer(model), cfg, "cpu",
                                        "fp32", md.MatchingAugment(augment, H, W), 11, k)
    return step, model


@pytest.mark.parametrize("arch", ["sc_depth", "manydepth"])
def test_fused_dispatch_equals_eager_steps(pool, arch):
    """Both models' steps go through one dispatch: two steps fused on the
    CPU equal two eager calls bit for bit (losses, parameters and, for
    ManyDepth, the trackers): the same batches, step counts and draws."""
    raw = tiny.frames(pool)
    batches = {"tgt": torch.from_numpy(raw[:2 * B].reshape(2, B, tiny.H, tiny.W, 3)),
               "refs": torch.from_numpy(np.stack([raw[1:2 * B + 1], raw[2:2 * B + 2]], 1)
                                        .reshape(2, B, 2, tiny.H, tiny.W, 3)),
               "intrinsics": torch.tensor([[50.0, 0, 64], [0, 50, 32], [0, 0, 1]])
               .expand(2, B, 3, 3).clone()}
    runs = []
    for k in (2, 1):
        step, nets = _train_step(arch, k)
        if k == 2:
            out = step(batches)["loss"]
        else:
            out = torch.stack([step({n: v[i] for n, v in batches.items()})["loss"]
                               for i in range(2)])
        runs.append((out, [p.detach().clone() for p in nets.parameters()],
                     getattr(step, "trackers", None)))
    assert runs[0][0].shape == (2,) and torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    if arch == "manydepth":
        assert torch.equal(runs[0][2], runs[1][2])


@pytest.mark.parametrize("fault", [None, "zeroed_volume", "wrong_bins"])
def test_a_broken_cost_volume_fails_the_comparison(tiny_cell, fault):
    """The cell's comparison (``check.judge`` over the numbers its limits
    file names, at the tests' limits) passes the sound program and fails it
    with the volume zeroed or the bins running to twice the upper tracker,
    planted as ``faults.py`` plants them on the card."""
    from benchmark.families.manydepth import faults

    with faults.planted(fault):
        first, want = _follow(tiny_cell, FAULT_SEED)
    ok, judged = check.judge(check.numbers(first, want), COMPARED)
    assert ok == (fault is None), judged


# ---- the cell and its configuration --------------------------------------------

def test_the_cell_resolves_with_its_frozen_flops():
    cell = spec.resolve(spec.load_benchmark(), CELL)
    assert cell.chips == 1 and cell.config["family"] == "manydepth"
    assert cell.traffic["name"] == "packed_fused16"
    flops = spec.family("manydepth", "flops").flops_per_step(cell.config)
    assert flops == cell.config["flops_per_step"]
    names = {m["name"] for m in cell.per_layer}
    assert {"cost_volume_ms", "cost_volume_roofline", "ssim_roofline", "mfu_pct"} <= names
    assert not {"data.decode_ms", "dist.nccl_ms"} & names
    kernels = spec.family("manydepth", "kernels")
    shapes = kernels.shapes(cell.config, cell.traffic)
    assert shapes["pairs"] == 24 and (shapes["height"], shapes["width"]) == (192, 640)
    assert kernels.KERNEL_BYTES["cost_volume"](shapes) == 4 * 12 * 48 * 160 * (64 * 2 + 98) \
        + 4 * (12 * 21 + 96)


def test_train_cli_runs_manydepth_on_a_packed_tree(tmp_path, monkeypatch):
    from PIL import Image

    from sc_sfmlearner_release_tpu_torch import train
    from sc_sfmlearner_release_tpu_torch.data import pack_dataset

    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    for scene in ("s1", "s2"):
        d = root / scene
        d.mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 255, (64, 128, 3), dtype=np.uint8)).save(
                d / f"{i:07d}.jpg")
        np.savetxt(d / "cam.txt", np.array([[50.0, 0, 64], [0, 50, 32], [0, 0, 1]]))
    (root / "train.txt").write_text("s1\ns2\n")
    (root / "val.txt").write_text("s2\n")
    pack_dataset(str(root))
    monkeypatch.chdir(tmp_path)
    assert train.main([str(root), "--arch", "manydepth", "--name", "md", "--device", "cpu",
                       "--precision", "fp32", "-b", "2", "-j", "2", "--epochs", "1",
                       "--epoch-size", "2", "--with-pretrain", "0", "--packed",
                       "--device-augment", "--fused-steps", "2", "--height", "64", "--width",
                       "128", "--num-depth-bins", "8", "--log-style", "line"]) == 0
    (run,) = (tmp_path / "checkpoints" / "md").iterdir()
    rows = (run / "progress_log_full.csv").read_text().splitlines()
    assert rows[0].split("\t") == list(md.METRIC_KEYS) and len(rows) == 3
    times = (run / "progress_log_time.csv").read_text().splitlines()
    assert [r.split("\t")[0] for r in times] == ["step", "1", "2"]
    state = torch.load(run / "manydepth.pth.tar", weights_only=False)
    assert state["step"] == 2 and state["trackers"].shape == (2,)
    assert state["args"]["num_scales"] == 4  # ManyDepth's four scales unless given
    with pytest.raises(SystemExit):
        train.main([str(root), "--arch", "manydepth", "--name", "md", "--device", "cpu",
                    "--with-pretrain", "0", "--packed"])
    with pytest.raises(SystemExit) as unknown:  # the trackers give the bins: no such flag
        train.main([str(root), "--arch", "manydepth", "--name", "md", "--device", "cpu",
                    "--with-pretrain", "0", "--packed", "--device-augment",
                    "--min-depth-bin", "0.5"])
    assert unknown.value.code == 2  # argparse's exit
