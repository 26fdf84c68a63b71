"""The port's train CLI on the CPU (``--device cpu --precision fp32``).

Two ways in, each over a tiny KITTI-format tree (64x96 frames, B2, ``-j 2``):
a packed tree with ``--device-augment`` (the path that trains on the card)
and the JPEG tree with the host transforms and ground-truth validation.
Checked: the CSV logs and the checkpoint layout, that ``--resume``
continues the step and Adam's state, ``--pretrained-disp/-pose`` from
``.pth.tar``, ``--with-pretrain 1`` with ``--imagenet-weights-dir`` and the
hard error without weights, that the flags the port leaves out are
rejected, and that the default ``--device cuda`` fails clearly without a
card.
"""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu_torch import train as cli
from sc_sfmlearner_release_tpu_torch.data import pack_dataset
from sc_sfmlearner_release_tpu_torch.models.resnet import ResNet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores: one torch
    thread each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 64, 96
BASE = ["--device", "cpu", "--precision", "fp32", "-b", "2", "-j", "2", "--epoch-size", "2",
        "--no-tensorboard", "--log-style", "line", "--val-batches", "1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.RandomState(0)
    k = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    for scene, n in (("s1", 6), ("s2", 5), ("v1", 4)):
        d = root / scene
        d.mkdir()
        for i in range(n):
            imageio.imwrite(d / f"{i:07d}.jpg", (rng.rand(H, W, 3) * 255).astype(np.uint8))
        np.savetxt(d / "cam.txt", k)
    for i in range(4):
        np.save(root / "v1" / f"{i:07d}.npy", rng.uniform(1, 80, (H, W)).astype(np.float32))
    (root / "train.txt").write_text("s1\ns2\n")
    (root / "val.txt").write_text("v1\n")
    pack_dataset(str(root))
    return str(root)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One working directory for the module's runs (``checkpoints/`` lands
    there); each test changes into it."""
    return tmp_path_factory.mktemp("runs")


def _run(workdir, argv, monkeypatch):
    monkeypatch.chdir(workdir)
    assert cli.main(argv) == 0
    (path,) = glob.glob(os.path.join(str(workdir), "checkpoints", argv[argv.index("--name") + 1],
                                     "*"))
    return path


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def packed_run(tree, workdir):
    with pytest.MonkeyPatch.context() as m:
        return _run(workdir, [tree, "--name", "packed", "--packed", "--device-augment",
                              "--with-pretrain", "0", "--epochs", "2", "--with-auto-mask", "1"]
                    + BASE, m)


def test_packed_device_augment_run_logs_and_checkpoints(packed_run):
    full = _rows(os.path.join(packed_run, "progress_log_full.csv"))
    assert full[0] == ["train_loss", "photo_loss", "smooth_loss", "geometry_consistency_loss"]
    assert len(full) == 1 + 4 and all(np.isfinite(float(v)) for r in full[1:] for v in r)
    summary = _rows(os.path.join(packed_run, "progress_log_summary.csv"))
    assert summary[0] == ["train_loss", "validation_loss"] and len(summary) == 3
    times = _rows(os.path.join(packed_run, cli.TIME_LOG))
    assert [int(r[0]) for r in times[1:]] == [1, 2, 3, 4]
    assert set(os.listdir(packed_run)) >= {
        "dispnet_checkpoint.pth.tar", "exp_pose_checkpoint.pth.tar",
        "dispnet_model_best.pth.tar", "exp_pose_model_best.pth.tar", "train_state.pth.tar",
        "meta.json", "progress_log_summary.csv", "progress_log_full.csv"}
    assert json.load(open(os.path.join(packed_run, "meta.json"))) == {"step": 4, "epoch": 2}
    blob = torch.load(os.path.join(packed_run, "dispnet_checkpoint.pth.tar"), weights_only=True)
    assert blob["epoch"] == 2 and "encoder.encoder.conv1.weight" in blob["state_dict"]


def test_resume_continues_the_step(tree, workdir, packed_run, monkeypatch):
    saved = torch.load(os.path.join(packed_run, "train_state.pth.tar"), weights_only=True)
    resumed = _run(workdir, [tree, "--name", "resumed", "--packed", "--device-augment",
                             "--with-pretrain", "0", "--epochs", "1", "--with-auto-mask", "1",
                             "--resume", packed_run] + BASE, monkeypatch)
    times = _rows(os.path.join(resumed, cli.TIME_LOG))
    assert [int(r[0]) for r in times[1:]] == [5, 6]
    after = torch.load(os.path.join(resumed, "train_state.pth.tar"), weights_only=True)
    assert after["step"] == 6 and saved["step"] == 4
    for i, moments in saved["optimizer"]["state"].items():
        assert float(after["optimizer"]["state"][i]["step"]) == 6
        assert not torch.equal(after["optimizer"]["state"][i]["exp_avg_sq"],
                               moments["exp_avg_sq"])


def test_jpeg_tree_with_host_transforms_and_ground_truth(tree, workdir, monkeypatch):
    run = _run(workdir, [tree, "--name", "jpeg", "--with-pretrain", "0", "--epochs", "1",
                         "--with-gt"] + BASE, monkeypatch)
    full = _rows(os.path.join(run, "progress_log_full.csv"))
    assert len(full) == 1 + 2 and all(np.isfinite(float(v)) for r in full[1:] for v in r)
    summary = _rows(os.path.join(run, "progress_log_summary.csv"))
    assert len(summary) == 2 and 0 < float(summary[1][1]) < 10  # abs_rel of the depths


def test_pretrained_nets_from_reference_checkpoints(tree, workdir, packed_run, monkeypatch):
    run = _run(workdir, [tree, "--name", "warm", "--packed", "--device-augment",
                         "--with-pretrain", "1", "--epochs", "1", "--epoch-size", "1", "--lr",
                         "0",
                         "--pretrained-disp", os.path.join(packed_run,
                                                           "dispnet_checkpoint.pth.tar"),
                         "--pretrained-pose", os.path.join(packed_run,
                                                           "exp_pose_checkpoint.pth.tar")]
               + BASE, monkeypatch)
    for name in ("dispnet", "exp_pose"):
        want = torch.load(os.path.join(packed_run, f"{name}_checkpoint.pth.tar"),
                          weights_only=True)["state_dict"]
        got = torch.load(os.path.join(run, f"{name}_checkpoint.pth.tar"),
                         weights_only=True)["state_dict"]
        # lr 0: the weights stay; the BatchNorm statistics move.
        for k, v in want.items():
            if k.endswith("weight") or k.endswith("bias"):
                assert torch.equal(got[k], v), k


def test_msgpack_weights_are_refused(tree, workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    with pytest.raises(SystemExit, match="tools/convert_checkpoint.py"):
        cli.main([tree, "--name", "msgpack", "--with-pretrain", "0",
                  "--pretrained-disp", "dispnet_checkpoint.msgpack"] + BASE)


@pytest.mark.parametrize("tracked", [True, False])
def test_with_pretrain_grafts_imagenet_weights(tree, workdir, tmp_path, monkeypatch, tracked):
    # tracked=False: no BatchNorm ``num_batches_tracked`` counters, as in
    # torchvision's published ImageNet files.
    g = torch.Generator().manual_seed(0)
    sd = {k: (torch.randn(v.shape, generator=g) * 0.05 if v.is_floating_point() else v)
          for k, v in ResNet(18, 1).state_dict().items()
          if tracked or not k.endswith("num_batches_tracked")}
    for k in sd:
        if "running_var" in k:
            sd[k] = sd[k].abs() + 1.0
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    torch.save(sd, tmp_path / "resnet18-0123abcd.pth")
    run = _run(workdir, [tree, "--name", f"imagenet-{tracked}", "--packed", "--device-augment",
                         "--with-pretrain", "1", "--imagenet-weights-dir", str(tmp_path),
                         "--epochs", "1", "--epoch-size", "1", "--lr", "0"] + BASE, monkeypatch)
    disp = torch.load(os.path.join(run, "dispnet_checkpoint.pth.tar"),
                      weights_only=True)["state_dict"]
    pose = torch.load(os.path.join(run, "exp_pose_checkpoint.pth.tar"),
                      weights_only=True)["state_dict"]
    conv1 = sd["conv1.weight"]
    assert torch.equal(disp["encoder.encoder.conv1.weight"], conv1)
    assert torch.equal(pose["encoder.encoder.conv1.weight"], torch.cat([conv1, conv1], 1) / 2)
    assert torch.equal(disp["encoder.encoder.layer4.1.conv2.weight"],
                       sd["layer4.1.conv2.weight"])


def test_with_pretrain_without_weights_is_an_error(tree, workdir, tmp_path, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("SCDEPTH_IMAGENET_DIR", raising=False)
    with pytest.raises(SystemExit, match="no ImageNet weights for resnet18"):
        cli.main([tree, "--name", "noweights", "--epochs", "1"] + BASE)


@pytest.mark.parametrize("flag", [["--sampler", "gather"], ["--spatial-shards", "2"],
                                  ["--distributed"]])
def test_left_out_flags_are_rejected(tree, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args([tree, "--name", "x"] + flag)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_default_device_needs_a_card(tree, workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args([tree, "--name", "x"]).device == "cuda"
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device"):
        cli.main([tree, "--name", "nocard", "--with-pretrain", "0"])
    assert not os.path.exists(os.path.join(str(workdir), "checkpoints", "nocard"))
