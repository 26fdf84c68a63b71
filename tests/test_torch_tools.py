"""The port's step tools against the JAX package's (CPU).

  * ``synthetic_scene`` at 4+2 frames against the JAX tool, file for file:
    JPEG bytes (the port's codec against ``imageio`` at quality 96),
    ``.npy`` depths and the text files equal.
  * ``overfit_check``: the scene's depth equal to the JAX tool's
    ``make_scene``, its texture within 3e-7 of it (the JAX tool enlarges it
    with ``cv2.resize(INTER_CUBIC)``; the port's numpy bicubic has
    OpenCV's taps and weights but not its vectorized column pass's order
    of rounding: measured 2.4e-7, 2 ulps); the reference frames rendered
    from one texture by each package's ``inverse_warp2`` (border padding)
    within 1e-5 (measured on a CPU: see the test); ``--steps 3`` on the
    CPU runs to its verdict line and exits by it.
  * ``mfu_report.flop_model``: the convolutions' FLOPs that
    ``FlopCounterMode`` counts on the port's nets equal an analytic count
    from the JAX variables' kernel shapes and each convolution's output
    size; the peak table, and a card it does not list raises.
  * ``ablate_step``: each variant builds a step at 64x128 on the CPU with
    K = 1 that takes a finite step; an unknown name raises.
  * ``profile_step``: the kernel groups, the calls' device windows, and
    a trace's summary; the tools exit clearly without a card, answer
    ``--help``, and import neither ``imageio`` nor ``cv2``.
"""

import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu_torch.tools import (
    ablate_step, mfu_report, overfit_check, profile_step, synthetic_scene,
)
from sc_sfmlearner_release_tpu_torch.utils.profiling import trace
from test_torch_models import jax_disp_vars, jax_pose_vars

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sc_sfmlearner_release_tpu_torch"
TEXTURE_TOL = 3e-7
REFS_TOL = 1e-5
NEW_MODULES = ["utils/msgpack.py", "tools/convert_checkpoint.py", "tools/synthetic_scene.py",
               "tools/overfit_check.py", "tools/mfu_report.py", "tools/profile_step.py",
               "tools/ablate_step.py"]
TOOLS = ["convert_checkpoint", "synthetic_scene", "overfit_check", "mfu_report", "profile_step",
         "ablate_step"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------- synthetic_scene


def test_synthetic_scene_equals_the_jax_tool(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool("synthetic_scene").make_dataset(str(tmp_path / "jax"), 4, 3, 2)
        synthetic_scene.make_dataset(str(tmp_path / "port"), 4, 3, 2)
    files = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert sum(f.endswith(".jpg") for f in files) == sum(f.endswith(".npy") for f in files) == 6
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


# ------------------------------------------------------------ overfit_check


def test_overfit_scene_matches_the_jax_tool():
    jtool = _jax_tool("overfit_check")
    want_tex, want_depth = jtool.make_scene(overfit_check.H, overfit_check.W)
    tex, depth = overfit_check.make_scene()
    assert tex.dtype == want_tex.dtype == np.float32 and tex.shape == want_tex.shape
    assert np.array_equal(depth, want_depth)
    assert np.abs(tex - want_tex).max() <= TEXTURE_TOL


def test_overfit_refs_match_the_jax_tool():
    jtool = _jax_tool("overfit_check")
    tex, depth = overfit_check.make_scene()
    k = overfit_check.intrinsics()
    poses = [np.array([s * overfit_check.SHIFT, 0, 0, 0, 0, 0], np.float32) for s in (1, -1)]
    with jax.default_matmul_precision("highest"):
        want = jtool.render_refs(tex, depth, poses, k)
    got = overfit_check.render_refs(tex, depth, poses, k)
    assert got.shape == want.shape == (2, overfit_check.H, overfit_check.W, 3)
    assert np.abs(got - want).max() <= REFS_TOL
    assert np.abs(got - tex).max() > 0.1  # the views moved


def test_overfit_check_runs_to_its_verdict(capsys):
    code = overfit_check.main(["--steps", "3", "--device", "cpu", "--precision", "fp32"])
    out = capsys.readouterr().out
    verdict = [ln for ln in out.splitlines() if ln.startswith("OVERFIT CHECK:")]
    assert verdict and code == (0 if verdict[0].endswith("PASS") else 1)
    assert "photo loss:" in out and "depth correlation" in out


# --------------------------------------------------------------- mfu_report


def _analytic_conv_flops(variables, h, w, decoder):
    """2 * kh * kw * I * O * output pixels of every kernel in a flax tree."""
    total = 0.0
    flat, _ = jax.tree_util.tree_flatten_with_path(variables["params"])
    for path, kernel in flat:
        names = [p.key for p in path]
        if names[-1] != "kernel":
            continue
        kh, kw, ci, co = kernel.shape
        if names[0] == "encoder" and names[1] == "conv1":
            stride = 2
        elif names[0] == "encoder":
            stage, block = int(names[1][5]), int(names[1][7])
            stride = 2 ** (stage + 1)
            if block == 0 and stage > 1 and names[2] == "conv1" and kh == 1:
                stride //= 2  # a bottleneck strides in its 3x3 conv2 (torchvision's v1.5)
        elif decoder == "pose":
            stride = 32
        elif names[1].startswith("upconv"):
            i, j = int(names[1][7]), int(names[1][9])
            stride = 2 ** (i + 1 - j)
        else:
            stride = 2 ** int(names[1][-1])
        total += 2.0 * kh * kw * ci * co * (h // stride) * (w // stride)
    return total


@pytest.mark.parametrize("layers", [18, 50])
def test_flop_model_counts_the_convolutions(layers):
    h, w = 64, 128
    _, dv = jax_disp_vars(layers)
    _, pv = jax_pose_vars()
    fwd = mfu_report.forward_flops(layers, h, w)
    assert fwd["disp"] == _analytic_conv_flops(dv, h, w, "disp") > 0
    assert fwd["pose"] == _analytic_conv_flops(pv, h, w, "pose") > 0
    fm = mfu_report.flop_model(1, 2, h, w, layers)
    assert fm["conv"] == fm["issued"] == 3 * (3 * fwd["disp"] + 4 * fwd["pose"])
    assert fm["warp"] == 0 and fm["useful"] == fm["conv"] + 2 * 4 * h * w * 8 * 5


def test_peak_table():
    assert mfu_report.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert mfu_report.peak_tflops("NVIDIA H100 PCIe") == 756.5
    with pytest.raises(ValueError, match="no bf16 peak is listed for 'Unlisted GPU'"):
        mfu_report.peak_tflops("Unlisted GPU")


# -------------------------------------------------------------- ablate_step


@pytest.mark.parametrize("name", sorted(ablate_step.CONFIGS))
def test_ablate_variant_builds_and_steps(name):
    step, batch, k, b = ablate_step.build(ablate_step.CONFIGS[name], "cpu", 1, hw=(64, 128))
    assert k == 1 and b == ablate_step.CONFIGS[name].get("batch", 4)
    assert batch["tgt"].shape == (b, 64, 128, 3)
    metrics = step(batch)
    assert torch.isfinite(metrics["loss"]).all(), name


def test_ablate_refuses_unknown_variants():
    assert ablate_step.parse_configs("full, no_ssim") == ["full", "no_ssim"]
    with pytest.raises(ValueError, match=r"unknown configs \['band64'\]"):
        ablate_step.parse_configs("full,band64")
    with pytest.raises(ValueError, match="unknown configs"):
        ablate_step.main(["--configs", "unpacked_decoder"])


# ------------------------------------------------------------- profile_step


def test_profile_groups():
    group = profile_step.group_of
    assert group("void warp_sample_bwd_kernel<true>(...)") == "warp_sample_bwd"
    assert group("void warp_sample_c4_kernel<false>(...)") == "warp_sample"
    assert group("void ssim_fwd::ssim_kernel<4>(...)") == "ssim"
    assert group("void ssim_bwd::ssim_bwd_kernel<4, true>(...)") == "ssim_bwd"
    assert group("void cudnn::batchnorm_bwtr_nhwc_semiPersist<float>") == "batch_norm"
    assert group("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>") == "layout"
    assert group("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "conv/gemm"
    assert group("void at::native::(anonymous)::multi_tensor_apply_kernel<Adam>") == "optimizer"
    assert group("reflection_pad2d_out_kernel<float>") == "pad/pool/upsample"
    assert group("something else") == "other"
    rows = [(3000.0, 6, "sm90_xmma_fprop"), (1000.0, 3, "ssim_kernel"), (500.0, 3, "x")]
    assert profile_step.group_ms(rows, 3) == {"conv/gemm": 1.0, "ssim": 1 / 3, "other": 1 / 6}
    # two calls' records, 400 us apart inside a call, 2 ms between calls
    intervals = [(0, 100), (500, 900), (850, 1000), (3000, 3200), (3300, 3400)]
    assert profile_step.call_windows_ms(intervals) == pytest.approx((1000 + 400) / 1e3)


def test_trace_summary_of_a_cpu_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    summary = profile_step.trace_summary(str(tmp_path))
    assert summary["device_kernels"] == 0 and summary["port_kernels"] == {}
    assert summary["window_ms"] > 0 and summary["threads_with_cpu_ops"] >= 1


# --------------------------------------------------------------- all tools


@pytest.mark.parametrize("module", [mfu_report, profile_step, ablate_step])
def test_card_tools_exit_clearly_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("name", TOOLS)
def test_tool_help(name):
    res = subprocess.run([sys.executable, "-m", f"sc_sfmlearner_release_tpu_torch.tools.{name}",
                          "--help"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage:")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_new_modules_import_no_imageio_or_cv2():
    for rel in NEW_MODULES:
        bad = {"imageio", "cv2", "msgpack", "flax"}.intersection(_imported_roots(PORT / rel))
        assert not bad, f"{rel} imports {sorted(bad)}"
