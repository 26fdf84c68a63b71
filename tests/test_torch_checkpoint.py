"""Port checkpoints, exact resume, the ImageNet graft and ``remat`` (CPU).

  * The port's ``dispnet_*``/``exp_pose_*`` ``.pth.tar`` files load through
    the JAX package's ``convert_disp_checkpoint``/``convert_pose_checkpoint``,
    and the JAX package's exports (``export_*`` + ``save_torch_checkpoint``)
    load into the port: disparities and poses agree within 1e-5 rel (fp32,
    the same convolutions summed in another order; for poses, which pass
    near 0, also abs 1e-5 of their largest).
  * Exact resume: 3 steps straight against 1 step, save, restore into fresh
    networks and optimizer, 2 more steps, with the device augmentation on:
    parameters, BatchNorm buffers, Adam state and step bit-equal.
  * ``graft_imagenet_encoder`` against the JAX package's on a synthetic
    torchvision-named state dict: equal.
  * ``remat`` against the plain step: losses, gradients and running
    statistics equal, the statistics moved once.
"""

import copy
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.models import convert as jconvert
from sc_sfmlearner_release_tpu_torch.data.device_augment import AugmentConfig, make_device_augment
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models import convert
from sc_sfmlearner_release_tpu_torch.models.resnet import ResNet
from sc_sfmlearner_release_tpu_torch.training import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_checkpoint,
)
from test_torch_models import jax_disp_vars, jax_pose_vars


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's files go when it ends: full-width checkpoints take
    hundreds of MB, and pytest keeps the temporary directories of its last
    three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores: one torch
    thread each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, N, H, W = 2, 2, 64, 96


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(B, H, W, 3).astype(np.float32), rng.rand(B, H, W, 3).astype(np.float32)


@functools.cache
def _jax_apply():
    jdisp, _ = jax_disp_vars(18)
    jpose, _ = jax_pose_vars()
    disp = jax.jit(lambda v, x: jdisp.apply(v, x, train=False)[0])
    pose = jax.jit(lambda v, a, b: jpose.apply(v, a, b, train=False))
    return disp, pose


def _jax_outputs(dv, pv):
    x, y = _images()
    disp, pose = _jax_apply()
    with jax.default_matmul_precision("highest"):
        return np.asarray(disp(dv, jnp.asarray(x))), np.asarray(pose(pv, jnp.asarray(x),
                                                                     jnp.asarray(y)))


def _port_outputs(disp_net, pose_net):
    x, y = (torch.from_numpy(a) for a in _images())
    disp_net.eval()
    pose_net.eval()
    with torch.no_grad():
        return disp_net(x)[0].numpy(), pose_net(x, y).numpy()


def _trained_nets(seed=4):
    """Port nets off their init: random BatchNorm statistics and affine."""
    g = torch.Generator().manual_seed(seed)
    nets = DispNet(18, generator=g), PoseNet(18, generator=g)
    with torch.no_grad():
        for net in nets:
            for name, t in net.state_dict().items():
                if "running_var" in name:
                    t.copy_(1.0 + torch.rand(t.shape, generator=g))
                elif "running_mean" in name or ".bn" in name or "downsample.1" in name:
                    if t.is_floating_point():
                        t.add_(0.1 * torch.randn(t.shape, generator=g))
    return nets


def _assert_outputs_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    scale = np.abs(want[1]).max()
    assert scale > 1e-5
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5 * scale)


def test_checkpoint_layout(tmp_path):
    disp, pose = _trained_nets()
    state = create_train_state(disp, pose)
    save_checkpoint(str(tmp_path), state, is_best=True, epoch=3)
    names = {"dispnet_checkpoint.pth.tar", "exp_pose_checkpoint.pth.tar",
             "dispnet_model_best.pth.tar", "exp_pose_model_best.pth.tar",
             "train_state.pth.tar", "meta.json"}
    assert set(os.listdir(tmp_path)) == names
    for prefix, net in (("dispnet", disp), ("exp_pose", pose)):
        blob = torch.load(tmp_path / f"{prefix}_checkpoint.pth.tar", weights_only=True)
        assert set(blob) == {"epoch", "state_dict"} and blob["epoch"] == 3
        own = net.state_dict()
        assert set(blob["state_dict"]) == set(own)
        assert all(torch.equal(blob["state_dict"][k], own[k]) for k in own)
    assert json.loads((tmp_path / "meta.json").read_text()) == {"step": 0, "epoch": 3}
    save_checkpoint(str(tmp_path / "thin"), state, is_best=False, full_state=False)
    assert set(os.listdir(tmp_path / "thin")) == {
        "dispnet_checkpoint.pth.tar", "exp_pose_checkpoint.pth.tar", "meta.json"}


def test_port_checkpoints_load_into_jax(tmp_path):
    disp, pose = _trained_nets()
    save_checkpoint(str(tmp_path), create_train_state(disp, pose), is_best=False, epoch=1)
    dv = jconvert.convert_disp_checkpoint(
        jconvert.load_torch_state_dict(str(tmp_path / "dispnet_checkpoint.pth.tar")), 18)
    pv = jconvert.convert_pose_checkpoint(
        jconvert.load_torch_state_dict(str(tmp_path / "exp_pose_checkpoint.pth.tar")), 18)
    _assert_outputs_close(_port_outputs(disp, pose), _jax_outputs(dv, pv))


def test_jax_exports_load_into_port(tmp_path):
    _, dv = jax_disp_vars(18)
    _, pv = jax_pose_vars()
    jconvert.save_torch_checkpoint(jconvert.export_disp_checkpoint(dv, 18),
                                   str(tmp_path / "d.pth.tar"), epoch=2)
    jconvert.save_torch_checkpoint(jconvert.export_pose_checkpoint(pv, 18),
                                   str(tmp_path / "p.pth.tar"), epoch=2)
    disp, pose = DispNet(18), PoseNet(18)
    disp.load_state_dict(convert.load_torch_state_dict(str(tmp_path / "d.pth.tar")))
    pose.load_state_dict(convert.load_torch_state_dict(str(tmp_path / "p.pth.tar")))
    _assert_outputs_close(_port_outputs(disp, pose), _jax_outputs(dv, pv))


def test_save_torch_checkpoint_round_trip(tmp_path):
    disp, _ = _trained_nets()
    convert.save_torch_checkpoint(disp.state_dict(), str(tmp_path / "d.pth.tar"), epoch=5)
    blob = torch.load(tmp_path / "d.pth.tar", weights_only=True)
    assert blob["epoch"] == 5
    back = convert.load_torch_state_dict(str(tmp_path / "d.pth.tar"))
    assert all(torch.equal(back[k], v) for k, v in disp.state_dict().items())


def _uint8_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    return [{"tgt": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
             "refs": rng.randint(0, 256, (B, N, H, W, 3)).astype(np.uint8),
             "intrinsics": np.broadcast_to(k, (B, 3, 3)).copy()} for _ in range(n)]


def _train(state, batches):
    step = make_train_step(state.disp_net, state.pose_net, state.optimizer, device="cpu",
                           precision="fp32", augment_fn=make_device_augment(AugmentConfig()),
                           aug_seed=5)
    return [float(step(b)["loss"]) for b in batches]


def _fresh_state(seed):
    g = torch.Generator().manual_seed(seed)
    disp, pose = DispNet(18, generator=g), PoseNet(18, generator=g)
    return create_train_state(disp, pose, make_optimizer(disp, pose, lr=1e-3), seed=seed)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for net_a, net_b in ((a.disp_net, b.disp_net), (a.pose_net, b.pose_net)):
        sa, sb = net_a.state_dict(), net_b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"] and set(oa["state"]) == set(ob["state"])
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_resume_is_exact(tmp_path):
    batches = _uint8_batches(3)
    straight = _fresh_state(0)
    losses = _train(straight, batches)

    first = _fresh_state(0)
    assert _train(first, batches[:1]) == losses[:1]
    save_checkpoint(str(tmp_path), first, is_best=False, epoch=1)
    resumed = restore_train_state(str(tmp_path), _fresh_state(9))
    assert resumed.step == 1
    assert _train(resumed, batches[1:]) == losses[1:]
    _assert_states_equal(resumed, straight)
    assert straight.step == 3


def test_restore_after_the_step_was_built(tmp_path):
    """A state restored under a step function that has already run keys the
    augmentation by the restored count, as a fresh step function would."""
    batches = _uint8_batches(3)
    straight = _fresh_state(0)
    losses = _train(straight, batches)

    first = _fresh_state(0)
    _train(first, batches[:1])
    save_checkpoint(str(tmp_path), first, is_best=False, epoch=1)
    resumed = _fresh_state(9)
    step = make_train_step(resumed.disp_net, resumed.pose_net, resumed.optimizer, device="cpu",
                           precision="fp32", augment_fn=make_device_augment(AugmentConfig()),
                           aug_seed=5)
    step(batches[0])
    restore_train_state(str(tmp_path), resumed)
    assert [float(step(b)["loss"]) for b in batches[1:]] == losses[1:]
    _assert_states_equal(resumed, straight)


def _torchvision_resnet(num_layers, seed, tracked=True):
    """A torchvision-named ImageNet state dict (random values, with ``fc``).
    ``tracked=False`` drops BatchNorm's ``num_batches_tracked`` counters, as
    torchvision's published ImageNet files have them."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v.clone())
          for k, v in ResNet(num_layers, 1).state_dict().items()
          if tracked or not k.endswith("num_batches_tracked")}
    for k in sd:
        if "running_var" in k:
            sd[k] = sd[k].abs() + 0.5
    width = 2048 if num_layers == 50 else 512
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, width, generator=g), torch.zeros(1000)
    return sd


@pytest.mark.parametrize("num_layers", [18, 50])
@pytest.mark.parametrize("images", [1, 2])
@pytest.mark.parametrize("tracked", [True, False])
def test_graft_imagenet_encoder_matches_jax(num_layers, images, tracked):
    sd = _torchvision_resnet(num_layers, seed=num_layers + images, tracked=tracked)
    g = torch.Generator().manual_seed(1)
    net = DispNet(num_layers, generator=g) if images == 1 else PoseNet(num_layers, generator=g)
    decoder = copy.deepcopy(net.decoder.state_dict())
    convert.graft_imagenet_encoder(net, sd, num_layers, images)
    to_jax = convert.disp_to_jax if images == 1 else convert.pose_to_jax
    got = to_jax(net.state_dict(), num_layers)
    empty = {"params": {"decoder": {}}, "batch_stats": {}}
    want = jconvert.graft_imagenet_encoder(empty, {k: v.numpy() for k, v in sd.items()},
                                           num_layers, images)
    flat_want = jax.tree_util.tree_leaves_with_path(
        {"params": want["params"]["encoder"], "batch_stats": want["batch_stats"]["encoder"]})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        {"params": got["params"]["encoder"], "batch_stats": got["batch_stats"]["encoder"]}))
    assert len(flat_want) == len(flat_got) > 60
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    assert all(torch.equal(net.decoder.state_dict()[k], v) for k, v in decoder.items())


def test_graft_refuses_another_layout():
    with pytest.raises(ValueError, match="ResNet-50"):
        convert.graft_imagenet_encoder(DispNet(18), _torchvision_resnet(18, 0), 50)


def test_remat_matches_the_plain_step():
    batch = _uint8_batches(1, seed=3)[0]
    runs = {}
    for remat in (False, True):
        state = _fresh_state(2)
        step = make_train_step(state.disp_net, state.pose_net, state.optimizer, device="cpu",
                               precision="fp32", remat=remat)
        metrics = step(batch)
        nets = (state.disp_net, state.pose_net)
        grads = {f"{i}.{n}": p.grad.clone() for i, net in enumerate(nets)
                 for n, p in net.named_parameters() if p.grad is not None}
        buffers = {f"{i}.{n}": b.clone() for i, net in enumerate(nets)
                   for n, b in net.named_buffers()}
        runs[remat] = metrics, grads, buffers
    (m0, g0, b0), (m1, g1, b1) = runs[False], runs[True]
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=0)
    assert set(g1) == set(g0) and len(g0) > 100
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9, msg=k)
    assert set(b1) == set(b0)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=0, atol=1e-6, msg=k)
    # Moved, and once: the recomputation's second move was undone.
    fresh = _fresh_state(2)
    start = dict(fresh.disp_net.named_buffers())
    assert not torch.equal(b1["0.encoder.encoder.bn1.running_mean"],
                           start["encoder.encoder.bn1.running_mean"])
    counts = {k: int(v) for k, v in b1.items() if k.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {1}
