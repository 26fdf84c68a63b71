"""Guards of the PyTorch port: it imports no JAX, CPU tensors take the plain
versions without launching a kernel, device tensors that need a gradient go
through the autograd Functions (forward kernel, then backward kernel), a
missing card or compiler raises, and ``chip_smoke.py`` fails without a
card."""

import ast
import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sc_sfmlearner_release_tpu_torch as port
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.ops import _build
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample
from sc_sfmlearner_release_tpu_torch.tools import ssim_variants
from sc_sfmlearner_release_tpu_torch.training import (
    make_eval_depth_step,
    make_eval_step,
    make_inference_fn,
    make_optimizer,
    make_train_step,
)

# The modules themselves: ``ops`` exports a function named ``ssim``.
ssim_mod = importlib.import_module("sc_sfmlearner_release_tpu_torch.ops.ssim")
warp_mod = importlib.import_module("sc_sfmlearner_release_tpu_torch.ops.warp")
ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "sc_sfmlearner_release_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "cv2", "sc_sfmlearner_release_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT_DIR / "parallel" / "spatial.py" in files
    for f in files:
        bad = FORBIDDEN.intersection(_imported_roots(f))
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_scripts_name_no_jax():
    """The port's shell flows run no JAX: no forbidden module is run or
    imported, no JAX or Pallas variable is set, and no script file of the
    repository (the JAX package's CLIs) is run."""
    scripts = sorted((PORT_DIR / "scripts").glob("*.sh"))
    assert len(scripts) == 13  # the root scripts' 12 and the port's ManyDepth script
    for f in scripts:
        text = f.read_text()
        modules = re.findall(r"python3?\s+-m\s+([\w.]+)", text) + re.findall(
            r"\bimport\s+([\w.]+)", text)
        bad = FORBIDDEN.intersection(m.split(".")[0] for m in modules)
        assert not bad, f"{f.relative_to(ROOT)} runs {sorted(bad)}"
        assert not re.search(r"\b(JAX|PALLAS)_\w+", text), f.name
        assert not re.search(r"\S+\.py\b", text), f.name


def test_cpu_tensors_launch_no_kernel():
    warp_sample.launches = 0
    ssim_nchw.launches = 0
    warp_sample(torch.rand(2, 5, 6, 4), torch.rand(2, 5, 6, 2) * 2 - 1)
    ssim_nchw(torch.rand(2, 3, 5, 6), torch.rand(2, 3, 5, 6))
    g = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    k = np.array([[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]], np.float32)
    batch = {"tgt": rng.rand(2, 64, 64, 3).astype(np.float32),
             "refs": rng.rand(2, 1, 64, 64, 3).astype(np.float32),
             "intrinsics": np.broadcast_to(k, (2, 3, 3)).copy()}
    metrics = make_eval_step(DispNet(18, generator=g), PoseNet(18, generator=g),
                             device="cpu", precision="fp32")(batch)
    assert np.isfinite(float(metrics["loss"]))
    assert warp_sample.launches == 0 and ssim_nchw.launches == 0


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    disp, pose = DispNet(18, generator=g), PoseNet(18, generator=g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(disp, pose)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inference_fn(disp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(disp, pose, make_optimizer(disp, pose))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_depth_step(disp)
    assert port.resolve_device("cpu").type == "cpu"


def test_graft_entry_and_distributed_init_need_a_card(monkeypatch):
    from sc_sfmlearner_release_tpu_torch import graft_entry
    from sc_sfmlearner_release_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    # The dry run runs on the card unless the CPU is asked for.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multigpu(2)
    for key, value in zip(distributed.TORCHRUN_ENV, ("0", "1", "0", "localhost", "1")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0, but 0 CUDA device"):
        distributed.init_distributed("cuda")
    assert not distributed.is_distributed()


def test_distributed_backend_follows_the_device_and_the_cards(monkeypatch):
    """NCCL with a card per rank of this host, gloo where ranks share cards
    (which NCCL refuses) and on the CPU."""
    from sc_sfmlearner_release_tpu_torch.parallel import distributed

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.backend_for("cuda:0") == "gloo"
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_for("cuda") == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.backend_for("cuda") == "gloo"


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        warp_sample(torch.zeros(1, 4, 4, 4, **meta), torch.zeros(1, 4, 4, 2, **meta))
    with pytest.raises(ValueError, match="CUDA device"):
        warp_sample(torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 4, 2, **meta))
    with pytest.raises(ValueError, match="CUDA device"):
        ssim_nchw(torch.zeros(1, 3, 4, 4, **meta), torch.zeros(1, 3, 4, 4, **meta))


def test_precision_is_validated():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="precision"):
        make_inference_fn(DispNet(18, generator=g), device="cpu", precision="fp16")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    src.write_text("// v2\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR


@pytest.fixture
def stubbed_kernels(monkeypatch):
    """The wrappers' device route on meta tensors, with every launcher
    stubbed to record its call and the plain versions forbidden."""
    calls = []

    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran on a device tensor")

    def warp_fwd(src, coords, mode):
        calls.append(("warp_sample", src.shape[-1]))
        return torch.zeros(coords.shape[:3] + src.shape[-1:], device=src.device)

    def warp_bwd(src, coords, dout, mode, grad_channels, need_coords):
        calls.append(("warp_sample_bwd", grad_channels, need_coords))
        dsrc = torch.zeros(src.shape[:3] + (grad_channels,), device=src.device)
        return dsrc if grad_channels else None, torch.zeros_like(coords) if need_coords else None

    def ssim_fwd(x, y):
        calls.append(("ssim_nchw",))
        return torch.zeros_like(x)

    def ssim_bwd(x, y, g, need_x=False):
        calls.append(("ssim_nchw_bwd", need_x))
        return torch.zeros_like(x) if need_x else None, torch.zeros_like(y)

    monkeypatch.setattr(_build, "check_tensors", lambda *args: None)
    monkeypatch.setattr(warp_mod, "grid_sample", forbidden)
    monkeypatch.setattr(ssim_mod, "ssim_nchw_plain", forbidden)
    monkeypatch.setattr(warp_mod, "_launch_fwd", warp_fwd)
    monkeypatch.setattr(warp_mod, "warp_sample_bwd", warp_bwd)
    monkeypatch.setattr(ssim_mod, "_launch_fwd", ssim_fwd)
    monkeypatch.setattr(ssim_mod, "ssim_nchw_bwd", ssim_bwd)
    return calls


@pytest.mark.parametrize("coords_grad", [True, False])
def test_warp_grad_goes_through_the_backward_kernel(stubbed_kernels, coords_grad):
    meta = dict(device="meta")
    depth = torch.zeros(2, 4, 5, 1, **meta, requires_grad=True)
    rgb = torch.zeros(2, 4, 5, 3, **meta, requires_grad=True)
    coords = torch.zeros(2, 3, 6, 2, **meta, requires_grad=coords_grad)
    out = warp_sample(depth, coords, "zeros", frozen=rgb)
    assert out.shape == (2, 3, 6, 4)
    out.sum().backward()
    # One forward launch on the packed [depth, RGB] source, one backward
    # launch for d(depth) alone and d(coords) only if asked; none for RGB.
    assert stubbed_kernels == [("warp_sample", 4), ("warp_sample_bwd", 1, coords_grad)]
    assert depth.grad.shape == depth.shape and rgb.grad is None
    assert (coords.grad is not None) == coords_grad
    with torch.no_grad():
        warp_sample(depth, coords, "zeros", frozen=rgb)
    assert stubbed_kernels[-1] == ("warp_sample", 4)


def test_ssim_grad_goes_through_the_backward_kernel(stubbed_kernels):
    meta = dict(device="meta")
    x = torch.zeros(2, 3, 4, 5, **meta)
    y = torch.zeros(2, 3, 4, 5, **meta, requires_grad=True)
    ssim_nchw(x, y).sum().backward()
    assert stubbed_kernels == [("ssim_nchw",), ("ssim_nchw_bwd", False)]
    assert y.grad.shape == y.shape and x.grad is None
    x.requires_grad_(True)
    ssim_nchw(x, y).sum().backward()
    assert stubbed_kernels[-1] == ("ssim_nchw_bwd", True) and x.grad.shape == x.shape


@pytest.mark.parametrize("name,replaces", [
    ("warp_sample", "tools/bench_pallas_warp.py::_pallas_fwd"),
    ("warp_sample", "ops/warp_band.py::_band_sample_bwd"),
    ("ssim", "ops/pallas_ssim.py::"),
    ("ssim_bwd", "ops/pallas_ssim.py:150-158"),
    ("decoder_input", "ops/reflect_pad.py"),
])
def test_kernel_sources_name_what_they_replace(name, replaces):
    text = (PORT_DIR / "csrc" / f"{name}.cu").read_text()
    assert replaces in text and "Bound: bytes" in text
    assert "cudaGetLastError" in text and 'extern "C"' in text


@pytest.mark.parametrize("types", ["float, float", "__nv_bfloat16, __nv_bfloat16",
                                   "float, __nv_bfloat16"])
def test_decoder_input_kernels_fall_in_the_pad_group(types):
    """The decoder-input kernels' names, as a trace gives them (demangled,
    with their template arguments and parameters), fall in the yardstick's
    pad/pool/upsample group, which held the PyTorch kernels they replace."""
    from benchmark import yardstick

    text = (PORT_DIR / "csrc" / "decoder_input.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", text)
    assert kernels == ["upsample_cat_reflection_pad_fwd", "upsample_cat_reflection_pad_bwd"]
    for kernel in kernels:
        src, out = types.split(", ")
        params = (f"{src} const*, float const*, {out}*" if kernel.endswith("fwd")
                  else f"{out} const*, {src}*, float*")
        name = (f"void (anonymous namespace)::{kernel}<{types}>({params}, "
                "(anonymous namespace)::Shape, int)")
        assert yardstick.group_of(name) == "pad/pool/upsample", name


def test_ssim_variants_still_apply_to_the_kernel_source():
    sources = ssim_variants.variant_sources()
    tables = ((ssim_variants.VARIANTS, "ssim.cu", "kernel"),
              (ssim_variants.BWD_VARIANTS, "ssim_bwd.cu", "bwd_kernel"))
    assert set(sources) == {name for table, _, _ in tables for name in table}
    for table, source, base in tables:
        for name in table:
            assert sources[name][0] == source, name
            assert (sources[name][1] == sources[base][1]) == (name == base), name


def test_ssim_variants_fail_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ssim_variants.main([]) != 0


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    # Alone in a directory, without the rest of the repository.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
