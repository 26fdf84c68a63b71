"""The JAX package's ``.msgpack`` checkpoints in the port (CPU).

  * The port's msgpack codec (``utils/msgpack.py``) against
    ``flax.serialization``: the same bytes for the same tree
    (``to_bytes``' encoding, keys in the same order) and the same tree back,
    over scalars, 0-d and empty arrays, every integer, unsigned and float
    dtype and bfloat16, maps and arrays past 15 and 65,535 entries, str and
    bin past each length width, every integer width, a PRNG key and a
    chunked array; malformed input raises naming the byte offset.
  * A JAX ``save_checkpoint`` directory (``create_train_state`` and 2 JAX
    steps, with and without weight decay) restored by the port: the nets'
    eval forward equals JAX's ``apply`` (depth and pose rel 1e-5, pose also
    abs 1e-5 of its largest, as ``test_torch_checkpoint.py``); Adam's
    moments equal ``mu``/``nu`` bit for bit and every ``step`` equals
    ``count``. One port step from the restored state against one JAX step
    from the JAX state on the same batch (augmentation off): losses rel
    1e-4 and BatchNorm statistics rel 1e-4 (abs 1e-5), as
    ``test_torch_train.py``; each tensor's move within rel L2 0.1 of JAX's
    (measured on a CPU: 4.8e-2 at worst, an encoder BatchNorm bias, where
    the gradients themselves differ at this kinky point, as
    ``test_torch_train.py`` says; decoders 1.1e-2), while a restore that
    loses Adam's count or its moments moves every tensor by rel 0.31 or
    more (median 0.57 and 0.73). With weight decay the DispNet heads of the
    scales the loss does not use move in JAX (``add_decayed_weights`` adds
    wd * p to their zero gradient) and not in the port (torch's Adam skips
    a parameter without a gradient): a known divergence, checked here.
  * The port's ``save_jax_checkpoint`` files read by JAX's
    ``restore_train_state`` and ``load_model_variables``: the same tree as
    the template's, leaf for leaf, and the same bytes JAX's own
    ``save_checkpoint`` writes for those values.
  * The port's ``tools/convert_checkpoint.py`` against the JAX tool, both
    directions, leaf for leaf.
  * The eval CLIs on a ``.msgpack`` against the same CLI on the
    ``.pth.tar`` it was converted from: equal outputs.
"""

import functools
import importlib.util
import os
import shutil

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.training import checkpoint as jckpt
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch import inference, run_inference, test_disp, test_pose, test_vo
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models import convert
from sc_sfmlearner_release_tpu_torch.tools import convert_checkpoint
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, create_train_state, make_optimizer, make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.checkpoint import (
    jax_train_state, load_jax_train_state, restore_train_state, save_jax_checkpoint,
)
from sc_sfmlearner_release_tpu_torch.utils import msgpack
from test_cli import REPO, H, W, image_dir, odom_root  # noqa: F401 (fixtures)
from test_torch_eval_cli import CPU, depth_list, disp_pth, pose_pth  # noqa: F401 (fixtures)
from test_torch_train import LR, _batch, _variables

RTOL = 1e-5          # eval forward, fp32 convolutions summed in another order
LOSS_RTOL = 1e-4     # as test_torch_train.py
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
MOVE_RTOL = 0.1      # parameter moves, rel L2 per tensor
WEIGHT_DECAY = 0.01


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's files go when it ends: full-width checkpoints take
    hundreds of MB, and pytest keeps the temporary directories of its last
    three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the codec


def _flax_bytes(tree):
    """flax's encoding of ``tree`` with its keys in their order
    (``to_bytes``; ``msgpack_serialize`` alone would sort them)."""
    return fs.msgpack_serialize(tree, in_place=True)


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
        -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64"]


def _case(name):
    rng = np.random.RandomState(0)
    if name == "scalars":
        return {"int": 7, "neg": -5, "float": 1.5, "true": True, "false": False, "none": None,
                "str": "x", "f32": np.float32(2.5), "i64": np.int64(-7), "u8": np.uint8(200),
                "bool_": np.bool_(True)}
    if name == "zero_d":
        return {"step": np.zeros((), np.int32), "f64": np.asarray(3.0), "u32": np.asarray(
            7, np.uint32)}
    if name == "empty":
        return {"a": np.zeros((0,), np.float32), "b": np.zeros((2, 0, 3), np.uint8), "c": {},
                "d": []}
    if name == "dtypes":
        return {d: (rng.rand(3, 4) * 100 - 50).astype(d) for d in DTYPES}
    if name == "bfloat16":
        return {"w": np.asarray(jnp.asarray(rng.randn(5, 3), jnp.bfloat16))}
    if name == "map_16":
        return {f"k{i}": {"v": np.arange(i, dtype=np.int32)} for i in range(20)}
    if name == "map_65536":
        return {f"{i}": i for i in range(70000)}
    if name == "array_16_65536":
        return {"short": list(range(20)), "long": list(range(70000))}
    if name == "bin":
        return {"b8": b"\x01" * 200, "b16": b"\x02" * 300, "b32": b"\x03" * 70000}
    if name == "str":
        return {"s5": "a" * 31, "s8": "b" * 200, "s16": "c" * 300, "s32": "d" * 70000,
                "utf8": "é深"}
    if name == "ints":
        return {"ints": INTS}
    if name == "prng_key":
        return {"rng": np.asarray(jax.random.PRNGKey(42))}
    if name == "big_dims":
        return {"x": np.zeros((1,) * 17, np.float32), "y": rng.rand(300, 300).astype(np.float32)}
    raise KeyError(name)


def _assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert list(got) == list(want), path
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got), got)
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", ["scalars", "zero_d", "empty", "dtypes", "bfloat16", "map_16",
                                  "map_65536", "array_16_65536", "bin", "str", "ints",
                                  "prng_key", "big_dims"])
def test_codec_matches_flax(name):
    tree = _case(name)
    want = _flax_bytes(tree)
    assert msgpack.packb(tree) == want
    _assert_trees_equal(msgpack.unpackb(want), fs.msgpack_restore(want))


def test_codec_reads_and_writes_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(70, dtype=np.float32).reshape(7, 10), "small": np.ones(3),
            "nested": {"big": np.arange(40, dtype=np.int64)}}
    want = _flax_bytes({k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()})
    assert b"__msgpack_chunked_array__" in want
    assert msgpack.packb(tree) == want
    _assert_trees_equal(msgpack.unpackb(want), fs.msgpack_restore(want))
    _assert_trees_equal(msgpack.unpackb(want), tree)


def test_codec_arrays_are_views_of_the_buffer():
    buf = bytearray(_flax_bytes({"w": np.arange(6, dtype=np.float32)}))
    w = msgpack.unpackb(buf)["w"]
    assert w.flags.writeable and not w.flags.owndata
    w[0] = 9.0  # a view: the buffer changes
    assert msgpack.unpackb(bytes(buf))["w"][0] == 9.0


@pytest.mark.parametrize("data,match", [
    (b"\x81\xa1a\xc1", "unknown type byte 0xc1 at byte 3"),
    (b"\x82\xa1a\x01", "truncated header at byte 4"),
    (b"\x81\xa1a\xc4\x05ab", "5 bytes asked, 2 left at byte 5"),
    (b"\x01\x02", "1 trailing bytes at byte 1"),
    (b"\x81\xa1a\xd4\x07\x00", "unknown ext type 7 at byte 3"),
    (fs.msgpack_serialize({"c": 1 + 2j}), "complex number .ext 2. met; the port reads arrays "
                                          "only at byte 3"),
    (fs.msgpack_serialize({"x": np.zeros(2, np.float32)}).replace(b"float32", b"float99"),
     "unsupported ndarray dtype 'float99' at byte 3"),
    (fs.msgpack_serialize({"x": np.zeros(2, np.float32)})[:-1] + b"\x00\x00",
     "trailing bytes"),
])
def test_codec_refuses_malformed_input(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(data)


# ------------------------------------------------- JAX's directory in the port


@functools.cache
def _jax_checkpoint(weight_decay: float, tmp: str):
    """A JAX save directory after 2 JAX steps (and the JAX state, batch,
    compiled step); JAX's own ``create_train_state`` and ``save_checkpoint``."""
    jdisp, jpose, dv, pv = _variables()
    tx = jstate.make_optimizer(lr=LR, weight_decay=weight_decay)
    state = jstate.create_train_state(jdisp, jpose, tx, jax.random.PRNGKey(3),
                                      disp_variables=dv, pose_variables=pv)
    step = jax.jit(jstep.make_train_step(jdisp, jpose, tx, jstep.LossConfig()))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            state, _ = step(state, batch)
        after, metrics = step(state, batch)
    path = os.path.join(tmp, f"jax_wd{weight_decay}")
    jckpt.save_checkpoint(path, state, is_best=True, epoch=1)
    return path, jax.tree_util.tree_map(np.asarray, (state, after, metrics))


@pytest.fixture(scope="module")
def ckpt_tmp(tmp_path_factory):
    """The module's JAX save directories (322 MB of train state each),
    removed after the module."""
    path = tmp_path_factory.mktemp("jax_ckpt")
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def _port_state(weight_decay):
    disp, pose = DispNet(18), PoseNet(18)
    return create_train_state(disp, pose, make_optimizer(disp, pose, lr=LR,
                                                         weight_decay=weight_decay))


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _adam(opt_state, weight_decay):
    return opt_state[1][0] if weight_decay else opt_state[0]


@pytest.mark.parametrize("weight_decay", [0.0, WEIGHT_DECAY])
def test_jax_train_state_restores_exactly(weight_decay, ckpt_tmp):
    path, (jstate_np, _, _) = _jax_checkpoint(weight_decay, ckpt_tmp)
    state = restore_train_state(path, _port_state(weight_decay))
    assert state.step == 2
    got = jax_train_state(state)  # the port's state, mapped back onto JAX's layout
    for key in ("params", "batch_stats"):
        want = _leaves(getattr(jstate_np, key))
        have = _leaves(got[key])
        assert set(have) == set(want) and len(want) > 50
        assert all(np.array_equal(have[k], want[k]) for k in want), key
    adam = _adam(jstate_np.opt_state, weight_decay)
    for key in ("mu", "nu"):
        want, have = _leaves(getattr(adam, key)), _leaves(_adam_tree(got, weight_decay)[key])
        assert set(have) == set(want)
        assert all(np.array_equal(have[k], want[k]) for k in want), key
    steps = {float(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {float(adam.count)} == {2.0}
    assert len(state.optimizer.state) == len(list(state.disp_net.parameters())) + len(
        list(state.pose_net.parameters()))


def _adam_tree(tree, weight_decay):
    return tree["opt_state"]["1"]["0"] if weight_decay else tree["opt_state"]["0"]


def test_restored_nets_evaluate_as_jax(ckpt_tmp):
    path, (jstate_np, _, _) = _jax_checkpoint(0.0, ckpt_tmp)
    jdisp, jpose, _, _ = _variables()
    state = restore_train_state(path, _port_state(0.0))
    x, y = (np.random.RandomState(s).rand(2, H_IMG, W_IMG, 3).astype(np.float32) for s in (5, 6))
    dvars = {"params": jstate_np.params["disp"], "batch_stats": jstate_np.batch_stats["disp"]}
    pvars = {"params": jstate_np.params["pose"], "batch_stats": jstate_np.batch_stats["pose"]}
    with jax.default_matmul_precision("highest"):
        want_disp = np.asarray(jdisp.apply(dvars, jnp.asarray(x), train=False)[0])
        want_pose = np.asarray(jpose.apply(pvars, jnp.asarray(x), jnp.asarray(y), train=False))
    state.disp_net.eval()
    state.pose_net.eval()
    with torch.no_grad():
        got_disp = state.disp_net(torch.from_numpy(x))[0].numpy()
        got_pose = state.pose_net(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(1.0 / got_disp, 1.0 / want_disp, rtol=RTOL, atol=0)
    scale = np.abs(want_pose).max()
    np.testing.assert_allclose(got_pose, want_pose, rtol=RTOL, atol=RTOL * scale)


H_IMG, W_IMG = 64, 96


@pytest.mark.parametrize("weight_decay", [0.0, WEIGHT_DECAY])
def test_one_step_from_the_restored_state_matches_jax(weight_decay, ckpt_tmp):
    path, (before, after, metrics) = _jax_checkpoint(weight_decay, ckpt_tmp)
    state = restore_train_state(path, _port_state(weight_decay))
    step = make_train_step(state.disp_net, state.pose_net, state.optimizer, LossConfig(),
                           device="cpu", precision="fp32")
    got = {k: float(v) for k, v in step(_batch()).items()}
    for k in ("loss", "photo_loss", "smooth_loss", "geometry_loss"):
        np.testing.assert_allclose(got[k], float(metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    assert state.step == 3
    new = jax_train_state(state)
    want_stats, got_stats = _leaves(after.batch_stats), _leaves(new["batch_stats"])
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)
    old, want, have = _leaves(before.params), _leaves(after.params), _leaves(new["params"])
    for k in want:
        moved_ref, moved = want[k] - old[k], have[k] - old[k]
        if any(f"dispconv_{s}" in k for s in (1, 2, 3)):  # no gradient: one scale is trained
            assert not np.any(moved), k
            assert np.any(moved_ref) == (weight_decay > 0 and k.endswith("['kernel']")), k
            continue
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= MOVE_RTOL, (k, rel)


def test_restore_refuses_a_mismatched_state(ckpt_tmp):
    path, _ = _jax_checkpoint(0.0, ckpt_tmp)
    with pytest.raises(ValueError, match="add_decayed_weights"):
        restore_train_state(path, _port_state(WEIGHT_DECAY))
    tree = convert.read_jax_variables(os.path.join(path, "train_state.msgpack"))
    tree["step"] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="at step 2, the checkpoint at 5"):
        load_jax_train_state(tree, _port_state(0.0))


# ------------------------------------------------- the port's files in JAX


def _port_trained_state(weight_decay):
    state = _port_state(weight_decay)
    disp_sd, pose_sd = convert.from_jax_variables(_variables()[2], _variables()[3], 18)
    state.disp_net.load_state_dict(disp_sd)
    state.pose_net.load_state_dict(pose_sd)
    step = make_train_step(state.disp_net, state.pose_net, state.optimizer, LossConfig(),
                           device="cpu", precision="fp32")
    for _ in range(2):
        step(_batch())
    return state


@pytest.mark.parametrize("weight_decay", [0.0, WEIGHT_DECAY])
def test_port_checkpoint_loads_in_jax(weight_decay, tmp_path):
    state = _port_trained_state(weight_decay)
    save_jax_checkpoint(str(tmp_path), state, is_best=True, epoch=2)
    assert sorted(os.listdir(tmp_path)) == sorted([
        "dispnet_checkpoint.msgpack", "exp_pose_checkpoint.msgpack", "dispnet_model_best.msgpack",
        "exp_pose_model_best.msgpack", "train_state.msgpack", "meta.json"])
    jdisp, jpose, dv, pv = _variables()
    tx = jstate.make_optimizer(lr=LR, weight_decay=weight_decay)
    template = jstate.create_train_state(jdisp, jpose, tx, jax.random.PRNGKey(0),
                                         disp_variables=dv, pose_variables=pv)
    restored = jckpt.restore_train_state(str(tmp_path), template)
    want = _leaves(jax_train_state(state))
    got_tree, ref_tree = (_leaves(fs.to_state_dict(t)) for t in (restored, template))
    assert set(got_tree) == set(ref_tree) == set(want) and len(ref_tree) > 400
    for k, ref in ref_tree.items():
        got = got_tree[k]
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        assert np.array_equal(got, want[k]), k
    assert int(restored.step) == 2 and int(_adam(restored.opt_state, weight_decay).count) == 2
    # The same bytes as JAX's own save_checkpoint of those values.
    jckpt.save_checkpoint(str(tmp_path / "jax"), restored, is_best=False)
    for name in ("train_state.msgpack", "dispnet_checkpoint.msgpack",
                 "exp_pose_checkpoint.msgpack"):
        assert (tmp_path / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    for prefix, net, vars_ in (("dispnet", "disp", dv), ("exp_pose", "pose", pv)):
        loaded = jckpt.load_model_variables(str(tmp_path / f"{prefix}_model_best.msgpack"), vars_)
        mine = {"params": restored.params[net], "batch_stats": restored.batch_stats[net]}
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b),
            loaded, mine))
    shutil.rmtree(tmp_path)  # two train states of 322 MB


# ------------------------------------------------------ convert_checkpoint


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoint", os.path.join(REPO, "tools", "convert_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("net,layers", [("disp", 18), ("disp", 50), ("pose", 18)])
def test_convert_checkpoint_matches_the_jax_tool(net, layers, tmp_path, capsys):
    g = torch.Generator().manual_seed(3)
    module = DispNet(layers, generator=g) if net == "disp" else PoseNet(layers, generator=g)
    pth = str(tmp_path / "net.pth.tar")
    convert.save_torch_checkpoint(module.state_dict(), pth, epoch=4)
    tool = _jax_tool()
    args = ["--net", net, "--resnet-layers", str(layers), "--epoch", "4"]
    for impl, name in ((tool, "jax"), (convert_checkpoint, "port")):
        assert impl.main([pth, str(tmp_path / f"{name}.msgpack")] + args) == 0
    trees = [fs.msgpack_restore((tmp_path / f"{n}.msgpack").read_bytes()) for n in ("jax", "port")]
    want, got = _leaves(trees[0]), _leaves(trees[1])
    assert set(got) == set(want) and len(want) > 50
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # Back: the JAX tool's .msgpack to .pth.tar by each tool.
    for impl, name in ((tool, "jax"), (convert_checkpoint, "port")):
        assert impl.main([str(tmp_path / "jax.msgpack"), str(tmp_path / f"{name}.pth.tar")]
                         + args) == 0
    blobs = [torch.load(tmp_path / f"{n}.pth.tar", weights_only=True) for n in ("jax", "port")]
    assert blobs[0]["epoch"] == blobs[1]["epoch"] == 4
    want, got = blobs[0]["state_dict"], blobs[1]["state_dict"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert "converted" in capsys.readouterr().out


# ------------------------------------------------------------ the eval CLIs


def _msgpack_of(pth, net, tmp_path):
    out = str(tmp_path / f"{net}.msgpack")
    assert convert_checkpoint.main([pth, out, "--net", net]) == 0
    return out


def test_eval_clis_read_msgpack_as_pth(disp_pth, pose_pth, depth_list, image_dir,  # noqa: F811
                                       odom_root, tmp_path):
    disp_mp, pose_mp = _msgpack_of(disp_pth, "disp", tmp_path), _msgpack_of(pose_pth, "pose",
                                                                           tmp_path)
    size = ["--img-height", str(H), "--img-width", str(W)]
    outs = {}
    for kind, d, p in (("pth", disp_pth, pose_pth), ("msgpack", disp_mp, pose_mp)):
        o = tmp_path / kind
        assert test_disp.main(["--pretrained-dispnet", d, "--resnet-layers", "18",
                               "--dataset-list", depth_list, "--output-dir", str(o / "disp"),
                               *size] + CPU) == 0
        assert test_vo.main(["--pretrained-posenet", p, "--dataset-dir",
                             os.path.join(odom_root, "sequences") + os.sep, "--sequence", "09",
                             "--output-dir", str(o / "vo"), *size] + CPU) == 0
        assert test_pose.main([p, "--dataset-dir", odom_root, "--sequences", "09",
                               "--output-dir", str(o / "pose"), *size] + CPU) == 0
        assert run_inference.main(["--pretrained", d, "--resnet-layers", "18", "--dataset-dir",
                                   image_dir, "--output-dir", str(o / "viz"), "--output-disp",
                                   *size] + CPU) == 0
        outs[kind] = (np.load(o / "disp" / "predictions.npy"), np.loadtxt(o / "vo" / "09.txt"),
                      np.load(o / "pose" / "predictions.npy"),
                      {f: (o / "viz" / f).read_bytes() for f in sorted(os.listdir(o / "viz"))})
    for a, b in zip(outs["msgpack"][:3], outs["pth"][:3]):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert outs["msgpack"][3] == outs["pth"][3] and outs["pth"][3]


def test_restore_reads_a_jax_dispnet_file(disp_pth, tmp_path):  # noqa: F811
    sd = convert.load_torch_state_dict(disp_pth)
    path = str(tmp_path / "d.msgpack")
    convert.write_jax_variables(path, convert.disp_to_jax(sd, 18))
    got = inference.restore_disp_state(path, 18)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
