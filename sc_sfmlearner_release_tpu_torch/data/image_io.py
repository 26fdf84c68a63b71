"""PNG decode and encode in numpy, and OpenCV's float resizes in torch.

The evaluation and inference CLIs read and write images through this module
instead of ``imageio`` and ``cv2``, which the card's machine does not have:

- :func:`read_png` decodes 8-bit grey, grey+alpha, RGB and RGBA PNGs with
  ``zlib`` and numpy (grey becomes 3 channels, alpha is dropped, as the JAX
  package's ``inference.load_image`` does) and raises on 16-bit, palette
  and interlaced files. Rows filtered with Average or Paeth depend on their
  left neighbour; they are reversed as a wavefront over the anti-diagonals
  of the image, one numpy step per diagonal across all rows.
- :func:`write_png` encodes with one of the five row filters.
- :func:`resize_area` and :func:`resize_linear` are ``cv2.resize``'s
  ``INTER_AREA`` and ``INTER_LINEAR`` on float32 tensors (on the CPU or the
  card): separable weight matrices built as OpenCV builds its tables, and
  ``F.interpolate``'s half-pixel bilinear with border clamp.
  :func:`resize_like_cv2` picks one as ``load_image`` does.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit only): grey, RGB, grey+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk after the signature, CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays: a left, b up, c up-left."""
    p1, p2 = b - c, a - c
    pa, pb, pc = np.abs(p1), np.abs(p2), np.abs(p1 + p2)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


@functools.lru_cache(maxsize=1)
def _paeth_offsets() -> np.ndarray:
    """Paeth's prediction minus c, mod 256, as a function of (p, q) =
    (a - c, b - c) alone: ``table[p * 511 + q]`` (negative keys index from
    the end; the 511**2 keys are distinct modulo its length)."""
    p, q = np.meshgrid(np.arange(-255, 256), np.arange(-255, 256), indexing="ij")
    table = np.empty(511 * 511, np.uint8)
    table[(p * 511 + q).ravel()] = (_paeth(p, q, np.zeros_like(p)) & 0xFF).ravel()
    return table


def _unfilter_rows(raw: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Images without Average or Paeth rows: one vectorized step per row."""
    out = np.empty_like(raw)
    prev = np.zeros_like(raw[0])
    for r, kind in enumerate(kinds):
        if kind == 0:
            out[r] = raw[r]
        elif kind == 1:
            np.cumsum(raw[r], axis=0, dtype=np.uint8, out=out[r])  # wraps mod 256
        else:
            np.add(raw[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Reverse every filter at once along the anti-diagonals of the image.

    Pixel (r, i) needs (r, i-1), (r-1, i) and (r-1, i-1), all on the two
    diagonals before its own, so one step per diagonal covers every row.
    The rows (with a zero row above the first and a zero column left of
    the image) are stored skewed, ``T[d, r] = X[r, d - r]``, so that each
    step reads and writes whole contiguous slices; cells left of the image
    stay 0, cells right of it hold values no pixel reads."""
    h, w, c = raw.shape
    rows, diags = h + 1, h + w + 2

    def skewed(t: np.ndarray) -> np.ndarray:
        # X[r, j] = T[r + j, r]: element offset r*(rows+1)*c + j*rows*c
        item = t.itemsize
        return np.lib.stride_tricks.as_strided(
            t, (rows, w + 1, c), ((rows + 1) * c * item, rows * c * item, item))

    rs = np.zeros((diags, rows, c), np.uint8)
    skewed(rs)[1:, 1:] = raw
    t = np.zeros_like(rs)
    present = [k for k in range(5) if (kinds == k).any()]
    masks = {k: (kinds == k)[:, None] for k in present}
    offsets, key_scale = _paeth_offsets(), np.int32(511)

    # Each predictor mod 256 (uint8 arithmetic wraps as the filters do).
    def average(a, b, c_):
        return (np.add(a, b, dtype=np.uint16) >> 1).astype(np.uint8)

    def paeth(a, b, c_):
        key = np.subtract(a, c_, dtype=np.int16) * key_scale + np.subtract(b, c_, dtype=np.int16)
        return c_ + offsets[key]

    predictors = {0: lambda a, b, c_: np.zeros_like(a), 1: lambda a, b, c_: a,
                  2: lambda a, b, c_: b, 3: average, 4: paeth}
    for d in range(2, diags - 1):
        a, b, c_ = t[d - 1, 1:], t[d - 1, :-1], t[d - 2, :-1]
        pred = predictors[present[0]](a, b, c_)
        for k in present[1:]:
            pred = np.where(masks[k], predictors[k](a, b, c_), pred)
        np.add(rs[d, 1:], pred, out=t[d, 1:])
    return skewed(t)[1:, 1:].copy()


def decode_png(data: bytes) -> np.ndarray:
    """8-bit PNG bytes -> uint8 ``[H, W, C]`` with the file's own channels
    (1 grey, 2 grey+alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit files are read")
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} (palette): only grey, grey+alpha, RGB "
                         "and RGBA are read")
    if interlace:
        raise ValueError("interlaced PNG: only non-interlaced files are read")
    c = _CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * c):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (1 + w * c)}")
    rows = rows.reshape(h, 1 + w * c)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {kinds.max()} is not one of 0-4")
    raw = rows[:, 1:].reshape(h, w, c)
    if (kinds >= 3).any():
        return _unfilter_wavefront(raw, kinds)
    return _unfilter_rows(raw, kinds)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8 RGB ``[H, W, 3]``: grey becomes 3 channels and
    alpha is dropped."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] <= 2:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img_u8: np.ndarray, filter_type: int = 0) -> None:
    """Write uint8 ``[H, W]`` (grey) or ``[H, W, C]`` (C = 1 grey, 2
    grey+alpha, 3 RGB, 4 RGBA) as an 8-bit PNG whose rows all use
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    colour = {v: k for k, v in _CHANNELS.items()}.get(c)
    if colour is None or not 0 <= filter_type <= 4:
        raise ValueError(f"write_png: {c} channels, filter {filter_type}")
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    upleft = np.zeros_like(x)
    upleft[:, c:] = up[:, :-c]
    pred = (np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft))[filter_type]
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = (x - pred) & 0xFF
    data = (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` fractional-overlap weights of a shrink, as
    OpenCV's ``computeResizeAreaTab`` makes them (its 1e-3 cut-offs too)."""
    scale = n_in / n_out
    wts = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx2 = min(int(np.floor(fsx2)), n_in - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        if sx1 - fsx1 > 1e-3:
            wts[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        wts[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            wts[dx, sx2] = np.float32(min(fsx2 - sx2, 1.0, cell) / cell)
    return wts


def _area_emulation_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` two-tap weights of OpenCV's ``INTER_AREA`` when
    either side grows (its "area" variant of bilinear), border clamped."""
    scale = n_in / n_out
    wts = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * (n_out / n_in))
        fx = 0.0 if fx <= 0 else float(fx - np.floor(fx))
        if sx >= n_in - 1:
            sx, fx = n_in - 1, 0.0
        wts[dx, sx] += np.float32(1.0 - fx)
        if fx:
            wts[dx, sx + 1] += np.float32(fx)
    return wts


@functools.lru_cache(maxsize=16)
def _weights(build, n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """One side's float32 weights on ``device``, built once per size."""
    return torch.as_tensor(build(n_in, n_out), dtype=torch.float32, device=device)


def _separable(img: torch.Tensor, build, height: int, width: int) -> torch.Tensor:
    wy = _weights(build, img.shape[-3], height, img.device)
    wx = _weights(build, img.shape[-2], width, img.device)
    rows = torch.einsum("xw,...hwc->...hxc", wx, img)
    return torch.einsum("yh,...hxc->...yxc", wy, rows)


def resize_area(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA)`` of a
    float32 ``[..., H, W, C]`` tensor: the fractional-overlap average where
    neither side grows, else OpenCV's two-tap emulation on both sides."""
    shrinks = img.shape[-3] >= height and img.shape[-2] >= width
    return _separable(img, _area_weights if shrinks else _area_emulation_weights, height, width)


def resize_linear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` (``INTER_LINEAR``) of a float32
    ``[..., H, W, C]`` tensor: half-pixel centres, border clamp."""
    lead = img.shape[:-3]
    x = img.reshape((-1,) + img.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=False)
    return out.permute(0, 2, 3, 1).reshape(lead + (height, width, img.shape[-1]))


def resize_like_cv2(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The JAX package's ``load_image`` resize: area when either side
    shrinks, else linear; the image itself when the size already fits."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (height, width):
        return img
    if h > height or w > width:
        return resize_area(img, height, width)
    return resize_linear(img, height, width)
