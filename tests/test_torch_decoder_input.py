"""``ops/decoder_input.py`` on the CPU: the plain version is the composition
the decoder ran before the kernel (nearest upsample, ``torch.cat``,
``reflect_pad1``), bit for bit, forward and gradients; ``DepthDecoder``'s
outputs and gradients are unchanged; the wrapper's device route (stubbed:
there is no card here) goes through the autograd Function, in the
convolution's dtype and channels-last, takes one halo column a side on
width shards, and refuses what the kernel cannot take; the kernel's index
arithmetic, written out in Python, gives a width shard's columns of the
whole image's input and gathers the adjoint. The kernel itself is held
against the plain version on the card by ``chip_smoke.py``'s
decoder-input phase.
"""

import importlib

import pytest
import torch
import torch.nn.functional as F

from sc_sfmlearner_release_tpu_torch.models.disp_net import ALPHA, BETA, SCALES, DepthDecoder
from sc_sfmlearner_release_tpu_torch.models.resnet import encoder_channels
from sc_sfmlearner_release_tpu_torch.parallel import distributed
from sc_sfmlearner_release_tpu_torch.parallel.spatial import reflect_pad1

di = importlib.import_module("sc_sfmlearner_release_tpu_torch.ops.decoder_input")

# (source shape or None, skip shape or None, scale): the decoder's cases and
# axes of size 1 (the deepest map of a 32-row image).
CASES = {
    "skip_only": (None, (2, 8, 3, 5), 1),
    "skip_only_one_row": (None, (2, 8, 1, 5), 1),
    "skip_only_one_column": (None, (1, 4, 3, 1), 1),
    "source_scale1": ((2, 16, 4, 6), None, 1),
    "source_scale1_one_row": ((2, 16, 1, 6), None, 1),
    "source_scale1_one_pixel": ((2, 8, 1, 1), None, 1),
    "source_scale2": ((2, 16, 3, 5), None, 2),
    "source_scale2_one_row": ((2, 8, 1, 4), None, 2),
    "source_and_skip": ((2, 16, 3, 4), (2, 8, 6, 8), 2),
    "source_and_skip_one_pixel": ((1, 8, 1, 1), (1, 4, 2, 2), 2),
}


def _old(x, skip, scale):
    """The decoder's input as ``DepthDecoder`` composed it before the
    kernel."""
    if x is None:
        return reflect_pad1(skip)
    if scale == 2:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    return reflect_pad1(x if skip is None else torch.cat([x, skip], 1))


def _inputs(case, dtype, seed=0):
    src_shape, skip_shape, scale = CASES[case]
    g = torch.Generator().manual_seed(seed)
    src = torch.randn(src_shape, generator=g).to(dtype) if src_shape else None
    skip = torch.randn(skip_shape, generator=g) if skip_shape else None
    return src, skip, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_the_old_composition(case, dtype):
    src, skip, scale = _inputs(case, dtype)
    if src is None and dtype != torch.float32:
        skip = skip.to(dtype)
    leaves = [t.requires_grad_(True) for t in (src, skip) if t is not None]
    old_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    got = di.decoder_input_plain(src, skip, scale)
    want = _old(old_leaves[0] if src is not None else None,
                old_leaves[-1] if skip is not None else None, scale)
    assert got.dtype == want.dtype and torch.equal(got, want)
    h, w = (skip.shape[2:] if skip is not None else (src.shape[2] * scale, src.shape[3] * scale))
    assert got.shape[2:] == (h + 2, w + 2)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(got.dtype)
    for a, b in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, old_leaves, g)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # The CPU route of the wrapper is the plain version.
    assert torch.equal(di.decoder_input(src, skip, scale), got)


def _old_decoder_forward(dec: DepthDecoder, feats):
    """``DepthDecoder.forward`` as it was before the kernel."""
    outputs = {}
    x = feats[-1]
    for k, i in enumerate(range(4, -1, -1)):
        x = F.elu(dec.decoder[2 * k].conv.conv(reflect_pad1(x)))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i > 0:
            x = torch.cat([x, feats[i - 1]], dim=1)
        x = F.elu(dec.decoder[2 * k + 1].conv.conv(reflect_pad1(x)))
        if i in SCALES:
            disp = torch.sigmoid(dec.decoder[10 + i].conv(reflect_pad1(x)).float())
            outputs[i] = disp if dec.head == "sigmoid" else ALPHA * disp + BETA
    return tuple(outputs[s] for s in SCALES)


@pytest.mark.parametrize("autocast", [False, True])
@pytest.mark.parametrize("head,layers", [("sc_depth", 18), ("sigmoid", 18), ("sc_depth", 50)])
def test_depth_decoder_on_the_cpu_is_unchanged(head, layers, autocast):
    torch.manual_seed(0)
    dec = DepthDecoder(encoder_channels(layers), head=head)
    g = torch.Generator().manual_seed(2)
    h, w = 64, 96
    feats = [torch.randn(2, c, h >> (i + 1), w >> (i + 1), generator=g).requires_grad_(True)
             for i, c in enumerate(encoder_channels(layers))]
    amp = torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast)
    with amp:
        got = dec(feats)
    got_grads = torch.autograd.grad(sum(o.sum() for o in got), [*feats, *dec.parameters()])
    with amp:
        want = _old_decoder_forward(dec, feats)
    want_grads = torch.autograd.grad(sum(o.sum() for o in want), [*feats, *dec.parameters()])
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


@pytest.fixture
def stubbed_route(monkeypatch):
    """The wrapper's device route on CPU tensors: every tensor taken for a
    card's, the launches replaced by the plain version in the kernel's
    layout and dtype, each launch recorded."""
    calls = []

    def fwd(x, skip, s):
        calls.append(("fwd", s.cs, s.ck, s.scale, s.out_dtype))
        plain = _kernel_fwd(x, skip, s).to(s.out_dtype)
        return plain.contiguous(memory_format=torch.channels_last)

    def bwd(g, s, need_src, need_skip):
        calls.append(("bwd", need_src, need_skip, g.dtype,
                      g.is_contiguous(memory_format=torch.channels_last)))
        halo = s.left + s.right
        dx = (torch.zeros((s.n, s.cs, s.h, s.w + halo), dtype=s.src_dtype)
              .contiguous(memory_format=torch.channels_last) if need_src else None)
        dskip = torch.zeros((s.n, s.ck, s.H, s.W + halo)) if need_skip else None
        return dx, dskip

    monkeypatch.setattr(di, "uses_kernel", lambda t: True)
    monkeypatch.setattr(di, "_launch_fwd", fwd)
    monkeypatch.setattr(di, "decoder_input_bwd", bwd)
    return calls


def test_device_route_goes_through_the_autograd_function(stubbed_route):
    src = torch.randn(2, 16, 3, 4, requires_grad=True)
    skip = torch.randn(2, 8, 6, 8)
    out = di.decoder_input(src, skip, 2)
    # No autocast on the card here: fp32.
    assert out.dtype == torch.float32 and out.shape == (2, 24, 8, 10)
    assert out.is_contiguous(memory_format=torch.channels_last)
    out.sum().backward()
    assert stubbed_route == [("fwd", 16, 8, 2, torch.float32), ("bwd", True, False,
                                                                 torch.float32, True)]
    assert src.grad.shape == src.shape and src.grad.dtype == torch.float32
    with torch.no_grad():
        di.decoder_input(None, skip.requires_grad_(True))
    assert stubbed_route[-1] == ("fwd", 0, 8, 1, torch.float32) and len(stubbed_route) == 3


def test_conv_dtype_follows_autocast_on_the_card(monkeypatch, stubbed_route):
    assert di.conv_dtype() == torch.float32
    monkeypatch.setattr(torch, "is_autocast_enabled", lambda device: device == "cuda")
    monkeypatch.setattr(torch, "get_autocast_dtype", lambda device: torch.bfloat16)
    assert di.conv_dtype() == torch.bfloat16
    # Under autocast a bf16 source and an fp32 skip assemble into bf16.
    src = torch.randn(1, 8, 2, 2, dtype=torch.bfloat16)
    out = di.decoder_input(src, torch.randn(1, 8, 4, 4), 2)
    assert out.dtype == torch.bfloat16 and stubbed_route[-1][-1] == torch.bfloat16


@pytest.mark.parametrize("args,error", [
    ((torch.zeros(1, 8, 2, 2), torch.zeros(1, 8, 5, 4), 2), ValueError),  # skip off the grid
    ((torch.zeros(1, 8, 2, 2), torch.zeros(2, 8, 4, 4), 2), ValueError),  # batch
    ((torch.zeros(1, 8, 2, 2), None, 3), ValueError),  # scale
    ((None, torch.zeros(1, 8, 2, 2), 2), ValueError),  # x2 without a source
    ((torch.zeros(1, 8, 2, 2, dtype=torch.float16), None, 1), TypeError),
    ((None, torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16), 1), TypeError),  # skips are fp32
    ((torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16), None, 1), TypeError),  # bf16 without autocast
    ((torch.zeros(1, 4, 2, 2), None, 1), ValueError),  # channels not in multiples of 8
    ((torch.zeros(1, 8, 2, 2), torch.zeros(1, 4, 4, 4), 2), ValueError),
])
def test_device_route_refuses_what_the_kernel_cannot_take(stubbed_route, args, error):
    with pytest.raises(error):
        di.decoder_input(*args)
    assert stubbed_route == []


def _fake_halo(x, left, right, dim=-1):
    """``distributed.halo`` on one process: one zero column in place of each
    neighbour's (``left``, ``right`` as the shard's sides have them)."""
    first, last = distributed.spatial_index() == 0, (distributed.spatial_index()
                                                      == distributed.spatial_count() - 1)
    zeros = lambda: torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype)
    return torch.cat(([] if first else [zeros()]) + [x] + ([] if last else [zeros()]), -1)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_width_shards_take_one_halo_column_a_side(monkeypatch, stubbed_route, index):
    monkeypatch.setattr(distributed, "spatial_count", lambda: 3)
    monkeypatch.setattr(distributed, "spatial_index", lambda: index)
    monkeypatch.setattr(distributed, "halo", _fake_halo)
    seen = []
    launch = di._launch_fwd
    monkeypatch.setattr(di, "_launch_fwd",
                        lambda x, skip, s: seen.append(s) or launch(x, skip, s))
    src = torch.randn(2, 16, 3, 4, requires_grad=True)
    skip = torch.randn(2, 8, 6, 8, requires_grad=True)
    out = di.decoder_input(src, skip, 2)
    (s,) = seen
    assert (s.left, s.right) == (int(index > 0), int(index < 2))
    assert (s.w, s.W, s.h, s.H) == (4, 8, 3, 6) and out.shape == (2, 24, 8, 10)
    out.sum().backward()
    # The halo's backward gave the shard's own columns their gradients.
    assert src.grad.shape == src.shape and skip.grad.shape == skip.shape


def _reflect(i, n):
    return 0 if n == 1 else (-i if i < 0 else (2 * n - 2 - i if i >= n else i))


def _stored(i, n, left, right):
    """``stored`` of ``csrc/decoder_input.cu``: the stored index that padded
    index ``i`` of ``n + 2`` reads."""
    return _reflect(i - 1 + left, left + n + right)


def _padded(e, n, left, right):
    """``padded`` of ``csrc/decoder_input.cu``: the padded indices that read
    stored index ``e``."""
    m = left + n + right
    p = [e + 1 - left]
    if not left and e == (1 if m > 1 else 0):
        p.append(0)
    if not right and e == (m - 2 if m > 1 else 0):
        p.append(n + 1)
    return p


def _kernel_fwd(x, skip, s):
    """The forward kernel's index arithmetic on NCHW tensors: the source's
    stored column of padded column xp is ``(stored + (left << shift) -
    left) >> shift``."""
    shift = s.scale // 2
    rows = [_reflect(yp - 1, s.H) for yp in range(s.H + 2)]
    cols = [_stored(xp, s.W, s.left, s.right) for xp in range(s.W + 2)]
    parts = []
    if x is not None:
        src_cols = [(e + (s.left << shift) - s.left) >> shift for e in cols]
        parts.append(x[:, :, [y >> shift for y in rows]][..., src_cols])
    if skip is not None:
        parts.append(skip[:, :, rows][..., cols])
    return torch.cat(parts, 1)


def _kernel_bwd(g, s):
    """The backward kernel's gather: each stored element sums the padded
    positions that read it (for the source, over its upsampled block)."""
    scale, halo = s.scale, s.left + s.right
    ws, Ws = s.w + halo, s.W + halo
    dx = torch.zeros((s.n, s.cs, s.h, ws), dtype=g.dtype) if s.cs else None
    for sy in range(s.h):
        for se in range(ws):
            for dy in range(scale):
                for dxx in range(scale):
                    e = (se - s.left) * scale + dxx + s.left
                    if 0 <= e < Ws:
                        for r in _padded(sy * scale + dy, s.H, 0, 0):
                            for c in _padded(e, s.W, s.left, s.right):
                                dx[:, :, sy, se] += g[:, :s.cs, r, c]
    dskip = torch.zeros((s.n, s.ck, s.H, Ws), dtype=g.dtype) if s.ck else None
    for y in range(s.H if s.ck else 0):
        for e in range(Ws):
            for r in _padded(y, s.H, 0, 0):
                for c in _padded(e, s.W, s.left, s.right):
                    dskip[:, :, y, e] += g[:, s.cs:, r, c]
    return [t for t in (dx, dskip) if t is not None]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("case", ["skip_only", "source_scale1", "source_scale2",
                                  "source_and_skip", "one_column_shards"])
def test_kernel_indexing_gives_a_shards_columns_of_the_whole_image(case, shards):
    # Widths that 4 shards divide, to 1 column a shard at scale 1.
    cases = {**CASES, "skip_only": (None, (2, 8, 3, 4), 1),
             "source_scale1": ((2, 8, 3, 4), None, 1), "source_scale2": ((2, 8, 3, 4), None, 2),
             "one_column_shards": ((1, 8, 2, 4), (1, 8, 4, 8), 2)}
    src_shape, skip_shape, scale = cases[case]
    g = torch.Generator().manual_seed(3)
    src = torch.randn(src_shape, generator=g, dtype=torch.float64) if src_shape else None
    skip = torch.randn(skip_shape, generator=g, dtype=torch.float64) if skip_shape else None
    leaves = [t.requires_grad_(True) for t in (src, skip) if t is not None]
    whole = di.decoder_input_plain(src, skip, scale)
    width = (whole.shape[3] - 2) // shards
    widths = ([width // scale] if src is not None else []) + ([width] if skip is not None else [])
    ct_whole, grads = torch.zeros_like(whole), [torch.zeros_like(t) for t in leaves]
    for i in range(shards):
        left, right = int(i > 0), int(i < shards - 1)
        cut = lambda t, wd: t[..., i * wd - left:(i + 1) * wd + right]
        xs = cut(src.detach(), width // scale) if src is not None else None
        ks = cut(skip.detach(), width) if skip is not None else None
        s = di._Shape(xs, ks, scale, torch.float64, left, right)
        want = whole.detach()[..., i * width:(i + 1) * width + 2]
        assert torch.equal(_kernel_fwd(xs, ks, s), want)
        ct = torch.randn((s.n, s.cs + s.ck, s.H + 2, s.W + 2), generator=g, dtype=torch.float64)
        ct_whole[..., i * width:(i + 1) * width + 2] += ct
        for acc, got, wd in zip(grads, _kernel_bwd(ct, s), widths):
            cut(acc, wd).add_(got)
    for a, b in zip(grads, torch.autograd.grad(whole, leaves, ct_whole)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
