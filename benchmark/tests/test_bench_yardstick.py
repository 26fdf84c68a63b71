"""The frozen yardsticks: FLOPs recounted, bytes at the canonical shapes,
peaks, kernel groups and the interval arithmetic; the ``sc_depth``
family's FLOPs and kernel bytes at every cell's shapes."""

import json
import os

import pytest

from benchmark import flops, run, spec, yardstick

CONFIGS = sorted(os.listdir(os.path.join(spec.ROOT, "benchmark", "configs")))
SC_DEPTH_FLOPS = spec.family("sc_depth", "flops")
SC_DEPTH_KERNELS = spec.family("sc_depth", "kernels")
BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_flops_recount(name):
    with open(os.path.join(spec.ROOT, "benchmark", "configs", name)) as f:
        cfg = json.load(f)
    assert flops.flops_per_step(cfg) == cfg["flops_per_step"]


def test_flops_match_the_published_counts():
    """1.8137 and 2.8796 TFLOP per step at B4 N2 832x256, as the port's own
    `tools/mfu_report.py` counts them."""
    base = {"pose_layers": 18, "batch_size": 4, "sequence_length": 3, "height": 256,
            "width": 832}
    count = SC_DEPTH_FLOPS.flops_per_step
    assert round(count(dict(base, resnet_layers=18)) / 1e12, 4) == 1.8137
    assert round(count(dict(base, resnet_layers=50)) / 1e12, 4) == 2.8796


def test_kernel_bytes_at_the_canonical_shapes():
    """136/177/123/164 MB for B4 N2 832x256 (16 pairs), PERF.md's bounds."""
    shapes = {"pairs": 16, "height": 256, "width": 832}
    mb = {k: round(fn(shapes) / 1e6) for k, fn in SC_DEPTH_KERNELS.KERNEL_BYTES.items()}
    assert mb == {"warp_sample": 136, "warp_sample_bwd": 177, "ssim": 123, "ssim_bwd": 164}
    assert yardstick.PEAK_HBM_BYTES_PER_S == 3.35e12
    assert yardstick.PEAK_BF16_FLOPS == 989.4e12


@pytest.mark.parametrize("kernel,group", [
    ("void warp_sample_bwd_c4_kernel(float4 const*, ...)", "warp_sample_bwd"),
    ("void warp_sample_c4_kernel(float4 const*, ...)", "warp_sample"),
    ("void ssim_bwd_kernel<4>(float const*, ...)", "ssim_bwd"),
    ("void ssim_kernel<4>(float const*, ...)", "ssim"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>", "batch_norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "conv/gemm"),
    ("void at::native::elementwise_kernel<128, 2>", "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("Memcpy HtoD (Pinned -> Device)", "copy/cast"),
    ("something new", "other"),
])
def test_kernel_groups(kernel, group):
    assert yardstick.group_of(kernel) == group


def test_intervals():
    spans = [(0, 10), (5, 12), (20, 30), (29, 31)]
    assert yardstick.union_us(spans) == 23
    assert yardstick.gaps(spans) == [(12, 20)]


def test_roofline_reads_nothing_without_its_kernel():
    rec = {"trace": {"kernels": [("void ssim_kernel<4>", 0.0, 50.0),
                                 ("void ssim_kernel<4>", 60.0, 100.0)], "steps": 3},
           "kernel_bytes": {"ssim": 122683392, "warp_sample": 136314880}}
    assert yardstick.roofline_pct("warp_sample", rec) is None
    share = yardstick.roofline_pct("ssim", rec)  # per launch: 45 us each
    assert share == pytest.approx(100 * 122.683392e6 / 3.35e12 / 45e-6)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_sc_depth_flops_and_bytes_at_each_cells_shapes(workload):
    """Every cell's FLOPs and kernel bytes, as the family counts them, are
    the numbers the harness counted before families (B4 N2 832x256 a card:
    16 pairs)."""
    cell = spec.resolve(BENCH, workload)
    frozen = {"sc_depth_r18_kitti": 1813696741376.0, "sc_depth_r50_kitti": 2879570051072.0}
    assert flops.flops_per_step(cell.config) == frozen[cell.config["name"]]
    rec = run.records(cell, {"window": None, "trace": None})
    assert rec["shapes"] == {"pairs": 16, "height": 256, "width": 832,
                             "global_batch": 4 * cell.traffic["world_size"]}
    assert rec["kernel_bytes"] == {"warp_sample": 136314880, "warp_sample_bwd": 177209344,
                                   "ssim": 122683392, "ssim_bwd": 163577856}
    assert rec["groups"] == ()


def test_a_familys_groups_take_only_what_the_shared_leave():
    """A family's group names its own kernels and never takes one from a
    shared group, so the shared per-layer metrics keep their meaning."""
    groups = (("toy", ("toy_kernel",)), ("conv_toy", ("conv",)))
    assert yardstick.group_of("void toy_kernel<4>", groups) == "toy"
    assert yardstick.group_of("void toy_kernel<4>") == "other"
    assert yardstick.group_of("ncclDevKernel_AllReduce", groups) == "nccl"
    assert yardstick.group_of("sm90_xmma_fprop_conv", groups) == "conv/gemm"
    assert yardstick.group_of("void toy_conv_kernel<4>", groups) == "conv/gemm"
    rec = {"trace": {"kernels": [("void toy_kernel<4>", 0.0, 10.0)], "steps": 1},
           "kernel_bytes": {"toy": 33500}, "groups": groups}
    assert yardstick.roofline_pct("toy", rec) == pytest.approx(100.0 * 33500 / 3.35e12 / 10e-6)
