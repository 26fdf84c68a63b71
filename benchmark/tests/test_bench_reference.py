"""The plain reference against the port's CPU path at a tiny size: the
same weights, the same loss and gradients, the same augmentation and host
transforms, and the same batches as the port's loader."""

import numpy as np
import pytest
import torch

from benchmark import dataset, follow, spec
from benchmark.tests import tiny
from benchmark.weights import init_weights

from sc_sfmlearner_release_tpu_torch.data import (BatchLoader, PackedSequenceSet,  # noqa: E402
                                                   SequenceSet, pack_dataset, transforms)
from sc_sfmlearner_release_tpu_torch.data.device_augment import (  # noqa: E402
    AugmentConfig, make_device_augment, step_generator)
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet  # noqa: E402
from sc_sfmlearner_release_tpu_torch.training import LossConfig  # noqa: E402
from sc_sfmlearner_release_tpu_torch.training.step import total_loss  # noqa: E402

reference = spec.family("sc_depth", "reference")
CFG = {"num_scales": 1, "with_ssim": True, "with_mask": True, "with_auto_mask": False,
       "photo_loss_weight": 1.0, "smooth_loss_weight": 0.1, "geometry_consistency_weight": 0.5}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return tiny.tiny_pool(str(tmp_path_factory.mktemp("pool")))


def _nets(layers, seed=7):
    port = {"disp": DispNet(layers), "pose": PoseNet(18)}
    ref = {"disp": reference.DispNet(layers), "pose": reference.PoseNet(18)}
    for nets in (port, ref):
        init_weights(nets, seed, torch.device("cpu"))
    return port, ref


@pytest.mark.parametrize("layers", [18, 50])
def test_weights_are_the_same_on_both_sides(layers):
    port, ref = _nets(layers)
    for name in port:
        a = dict(port[name].named_parameters())
        b = dict(ref[name].named_parameters())
        assert sorted(a) == sorted(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("auto_mask", [False, True])
def test_loss_and_gradients_match_the_port(pool, auto_mask):
    torch.manual_seed(0)
    port, ref = _nets(18)
    b, n = 2, 2
    frames = torch.from_numpy(tiny.frames(pool)[:3 * b].astype(np.float32) / 255.0)
    frames = ((frames - 0.45) / 0.225).view(b, 1 + n, tiny.H, tiny.W, 3)
    k = torch.tensor([[60.0, 0, 64], [0, 62.0, 32], [0, 0, 1]]).expand(b, 3, 3).clone()
    cfg = dict(CFG, with_auto_mask=auto_mask)
    batch = {"tgt": frames[:, 0], "refs": frames[:, 1:], "intrinsics": k}
    loss_port, _ = total_loss(port["disp"], port["pose"], batch,
                              LossConfig(with_auto_mask=auto_mask), precision="fp32", train=True)
    loss_port.backward()
    nchw = frames.permute(0, 1, 4, 2, 3)
    loss_ref, _ = reference.loss(ref["disp"], ref["pose"], nchw[:, 0], nchw[:, 1:], k, cfg)
    loss_ref.backward()
    assert float(loss_port.detach()) == pytest.approx(float(loss_ref.detach()), rel=1e-5 if not auto_mask else 1e-4)
    if auto_mask:  # a pixel's mask can flip on rounding
        return
    pairs = [(f"{name}.{key}", p.grad, dict(ref[name].named_parameters())[key].grad)
             for name in port for key, p in port[name].named_parameters()]
    norms = sorted(float(gr.norm()) for _, _, gr in pairs if gr is not None)
    median = norms[len(norms) // 2]
    for key, gp, gr in pairs:
        if gr is None:
            assert gp is None or float(gp.abs().max()) == 0.0, key
            continue
        assert float((gp - gr).norm()) <= 1e-3 * max(float(gr.norm()), median), key


def test_device_augmentation_matches_the_port(pool):
    raw = torch.from_numpy(tiny.frames(pool)[:6]).view(2, 3, tiny.H, tiny.W, 3)
    k = torch.tensor([[60.0, 0, 64], [0, 62.0, 32], [0, 0, 1]]).expand(2, 3, 3).clone()
    batch = {"tgt": raw[:, 0], "refs": raw[:, 1:], "intrinsics": k}
    for seed, step in ((3, 0), (2 ** 31 + 5, 7)):
        out = make_device_augment(AugmentConfig())(step_generator(seed, step), batch)
        frames, k2 = follow.device_augment(raw.float() / 255.0, k,
                                           follow.step_draws(seed, step, 2))
        assert torch.allclose(frames[:, 0], out["tgt"], atol=1e-6)
        assert torch.allclose(frames[:, 1:], out["refs"], atol=1e-6)
        assert torch.allclose(k2, out["intrinsics"], atol=1e-5)


def test_host_transform_matches_the_port(pool):
    images = [f.astype(np.float32) for f in tiny.frames(pool)[:3]]
    k = np.array([[60.0, 0, 64], [0, 62.0, 32], [0, 0, 1]], np.float32)
    for seed in range(6):
        rng = lambda: np.random.default_rng(np.random.SeedSequence([seed, 11]))
        got, k_port = transforms.train_transform()(list(images), k.copy(), rng())
        want, k_ref = follow.host_transform(list(images), k.copy(), rng())
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.array_equal(k_port, k_ref)


@pytest.mark.parametrize("packed", [True, False])
def test_batches_are_the_port_loaders(pool, tmp_path, packed):
    """The reference's first batches, rebuilt from the seed, are the port's
    loader's (raw uint8 frames for a packed mix; transformed frames from
    JPEGs), in the same order."""
    seed = 2 ** 31 + 3
    traffic = {"pool": pool, "scenes": 2, "frames_per_scene": 8, "world_size": 1,
               "device_augment": packed}
    cfg = {"sequence_length": 3, "batch_size": 2, "fused_steps": 2}
    files = dataset.pool_files(traffic)
    scenes = dataset.layout(seed, 2, 8, len(files))
    root = dataset.write_tree(str(tmp_path / "tree"), scenes, files)
    if packed:
        pack_dataset(root)
        data = PackedSequenceSet(str(tmp_path / "tree" / "packed"), train=True)
    else:
        data = SequenceSet(root, train=True, transform=transforms.train_transform())
    loader = BatchLoader(data, 2, shuffle=True, num_workers=2, seed=seed)
    batches = follow.Batches(cfg, traffic, seed, torch.device("cpu"), files)
    for step, got in zip(range(3), loader):
        if packed:
            _, idx = batches.indices(step)
            want = np.stack([np.stack([batches.frames[t]] + [batches.frames[r] for r in refs])
                             for t, refs, _ in (batches.samples[i] for i in idx)])
            assert np.array_equal(got["tgt"], want[:, 0])
            assert np.array_equal(got["refs"], want[:, 1:])
            assert np.array_equal(got["intrinsics"], np.stack(
                [batches.samples[i][2] for i in idx]))
        else:
            tgt, refs, k = batches(step)
            assert np.array_equal(got["tgt"], tgt.permute(0, 2, 3, 1).numpy())
            assert np.array_equal(got["refs"], refs.permute(0, 1, 3, 4, 2).numpy())
            assert np.array_equal(got["intrinsics"], k.numpy())
