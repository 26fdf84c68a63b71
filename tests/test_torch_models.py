"""Port DispNet/PoseNet against the JAX package's (CPU), weights carried
across by ``from_jax_variables``.

The JAX models run at their defaults (lane-packed decoder and layer1),
the port runs the unpacked math; both in eval mode, fp32, on JAX-initialised
variables whose BatchNorm statistics and affine parameters are made
non-trivial. Tolerance rel 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.models import DispNet as JDispNet
from sc_sfmlearner_release_tpu.models import PoseNet as JPoseNet
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import (
    disp_from_jax,
    from_jax_variables,
    to_jax_variables,
)

B, H, W = 2, 64, 96
RTOL = 1e-4


def randomize_bn(variables, seed):
    """Numpy copy of flax variables with random BN statistics and affine."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)

    def walk(tree, name):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, k)
            elif name == "bn":
                shape = v.shape
                v[...] = {
                    "mean": rng.randn(*shape) * 0.1,
                    "var": 1.0 + rng.rand(*shape),
                    "scale": 1.0 + rng.randn(*shape) * 0.1,
                    "bias": rng.randn(*shape) * 0.1,
                }[k]

    walk(out, "")
    return out


@functools.cache
def jax_disp_vars(num_layers, seed=0):
    model = JDispNet(num_layers=num_layers)
    v = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))
    return model, randomize_bn(v, seed)


@functools.cache
def jax_pose_vars(seed=1):
    model = JPoseNet(num_layers=18)
    x = jnp.zeros((1, H, W, 3))
    v = jax.jit(lambda k, a: model.init(k, a, a, train=True))(jax.random.PRNGKey(seed), x)
    return model, randomize_bn(v, seed)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("num_layers", [18, 50])
def test_disp_net_matches_jax_packed(num_layers):
    jmodel, dv = jax_disp_vars(num_layers)
    x = np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(dv, jnp.asarray(x))
    net = DispNet(num_layers)
    net.load_state_dict(disp_from_jax(dv, num_layers))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for s, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == r.shape == (B, H >> s, W >> s, 1)
        _close(g, r, atol=1e-6)


def test_pose_net_matches_jax():
    jmodel, pv = jax_pose_vars()
    rng = np.random.RandomState(1)
    x1, x2 = (rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
            pv, jnp.asarray(x1), jnp.asarray(x2))
    _, dv = jax_disp_vars(18)
    _, pose_sd = from_jax_variables(dv, pv, 18)
    net = PoseNet(18)
    net.load_state_dict(pose_sd)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2))
    assert tuple(got.shape) == (B, 6)
    _close(got, ref, atol=1e-8)


def test_variables_round_trip():
    _, dv = jax_disp_vars(18)
    _, pv = jax_pose_vars()
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    # The port's modules take the converted dicts strictly, key for key.
    DispNet(18).load_state_dict(disp_sd, strict=True)
    PoseNet(18).load_state_dict(pose_sd, strict=True)
    back_d, back_p = to_jax_variables(disp_sd, pose_sd, 18)
    for want, got in ((dv, back_d), (pv, back_p)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf)


def test_port_state_dict_round_trip():
    """Port weights -> JAX variables -> port weights is the identity."""
    g = torch.Generator().manual_seed(3)
    disp, pose = DispNet(18, generator=g), PoseNet(18, generator=g)
    dv, pv = to_jax_variables(disp.state_dict(), pose.state_dict(), 18)
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    for net, sd in ((disp, disp_sd), (pose, pose_sd)):
        own = net.state_dict()
        assert set(own) == set(sd)
        for k, v in own.items():
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_generator_init_is_deterministic():
    a = DispNet(18, generator=torch.Generator().manual_seed(7)).state_dict()
    b = DispNet(18, generator=torch.Generator().manual_seed(7)).state_dict()
    c = DispNet(18, generator=torch.Generator().manual_seed(8)).state_dict()
    key = "encoder.encoder.conv1.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert torch.equal(a["decoder.decoder.0.conv.conv.bias"], b["decoder.decoder.0.conv.conv.bias"])
