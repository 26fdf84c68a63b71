"""The frozen yardsticks: FLOPs recounted, bytes at the canonical shapes,
peaks, kernel groups and the interval arithmetic."""

import json
import os

import pytest

from benchmark import flops, spec, yardstick

CONFIGS = sorted(os.listdir(os.path.join(spec.ROOT, "benchmark", "configs")))


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
    assert round(flops.flops_per_step(dict(base, resnet_layers=18)) / 1e12, 4) == 1.8137
    assert round(flops.flops_per_step(dict(base, resnet_layers=50)) / 1e12, 4) == 2.8796


def test_kernel_bytes_at_the_canonical_shapes():
    """136/177/123/164 MB for B4 N2 832x256 (16 pairs), PERF.md's bounds."""
    mb = {k: round(fn(16, 256, 832) / 1e6) for k, fn in yardstick.KERNEL_BYTES.items()}
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
           "shapes": {"pairs": 16, "height": 256, "width": 832}}
    assert yardstick.roofline_pct("warp_sample", rec) is None
    share = yardstick.roofline_pct("ssim", rec)  # per launch: 45 us each
    assert share == pytest.approx(100 * 122.683392e6 / 3.35e12 / 45e-6)
