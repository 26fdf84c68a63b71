"""The port's PNG reader/writer and OpenCV-exact resizes
(``sc_sfmlearner_release_tpu_torch/data/image_io.py``), and its image
loading (``inference.py``) against the JAX package's ``load_image`` and
``batched``.

``read_png`` is held bit-exact against ``imageio`` on PNGs written by
``cv2`` (libpng's adaptive filters and each single filter), by PIL and by
``write_png`` with each filter type, in RGB, grey and RGBA; the wavefront
that reverses Average and Paeth rows against a per-byte loop. Resizes
against ``cv2.resize``: area within 1e-3 grey levels (measured 4.6e-5 at
375x1242 -> 256x832), linear within 2e-2 on [0, 255] (measured 9.1e-3
growing 200x600 -> 256x832).
"""

import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from sc_sfmlearner_release_tpu import inference as jinf
from sc_sfmlearner_release_tpu_torch import inference as pinf
from sc_sfmlearner_release_tpu_torch.data.image_io import (
    decode_png, read_png, resize_area, resize_like_cv2, resize_linear, write_png,
)

AREA_TOL = 1e-3     # grey levels
LINEAR_TOL = 2e-2   # grey levels


def _image(h, w, seed=0):
    """Gradients, a block of noise and a sine band: libpng's adaptive
    filtering picks several row filters for it."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 2) % 256, (y * 3) % 256, ((x + y) * 1.5) % 256], -1).astype(np.uint8)
    img[h // 3:2 * h // 3, w // 4:3 * w // 4] = rng.randint(0, 256, (2 * h // 3 - h // 3,
                                                                    3 * w // 4 - w // 4, 3))
    img[:, -w // 5:] = (np.sin(x[:, -w // 5:] / 3.0) * 60 + 120).astype(np.uint8)[..., None]
    return img


def _as_mode(img, mode):
    if mode == "grey":
        return img[..., 1].copy()
    if mode == "rgba":
        return np.concatenate([img, img[..., :1] // 2 + 7], axis=-1)
    return img


def _imageio_rgb(path):
    ref = np.asarray(imageio.imread(path))
    if ref.ndim == 2:
        ref = np.stack([ref] * 3, axis=-1)
    return ref[..., :3]


def _row_filters(path):
    data = open(path, "rb").read()
    pos, idat, h = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            h = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(rows.reshape(h, -1)[:, 0].tolist())


def _write_cv2(path, img, flag):
    bgr = img if img.ndim == 2 else np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    params = [] if flag is None else [cv2.IMWRITE_PNG_FILTER, flag]
    assert cv2.imwrite(str(path), bgr, params)


WRITERS = {
    "cv2_adaptive": lambda p, img: _write_cv2(p, img, cv2.IMWRITE_PNG_ALL_FILTERS),
    "cv2_default": lambda p, img: _write_cv2(p, img, None),
    "cv2_avg": lambda p, img: _write_cv2(p, img, cv2.IMWRITE_PNG_FILTER_AVG),
    "cv2_paeth": lambda p, img: _write_cv2(p, img, cv2.IMWRITE_PNG_FILTER_PAETH),
    "pil": lambda p, img: Image.fromarray(img).save(p),
    **{f"write_png_{k}": (lambda k: lambda p, img: write_png(str(p), img, k))(k)
       for k in range(5)},
}


@pytest.mark.parametrize("mode", ["rgb", "grey", "rgba"])
@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_read_png_bit_exact_against_imageio(tmp_path, writer, mode):
    img = _as_mode(_image(37, 53 if mode != "rgb" else 70), mode)
    path = tmp_path / "x.png"
    WRITERS[writer](path, img)
    got = read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, _imageio_rgb(str(path)))


def test_adaptive_writers_mix_row_filters(tmp_path):
    """The adaptive files above hold several filter types, Paeth among
    them: the wavefront reverses rows of different filters together."""
    for writer in ("cv2_adaptive", "pil"):
        path = tmp_path / f"{writer}.png"
        WRITERS[writer](path, _image(96, 128))
        kinds = _row_filters(path)
        assert len(kinds) >= 3 and 4 in kinds, (writer, kinds)
        np.testing.assert_array_equal(read_png(str(path)), _image(96, 128))


def _unfilter_loop(rows, c):
    """The PNG specification's per-byte reconstruction, as a reference."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.int64)
    for r in range(h):
        kind = rows[r, 0]
        for i in range(n):
            x = int(rows[r, 1 + i])
            a = out[r, i - c] if i >= c else 0
            b = out[r - 1, i] if r else 0
            cc = out[r - 1, i - c] if r and i >= c else 0
            if kind == 1:
                x += a
            elif kind == 2:
                x += b
            elif kind == 3:
                x += (a + b) // 2
            elif kind == 4:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                x += a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out[r, i] = x % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_wavefront_equals_per_byte_loop(channels):
    """Random filter bytes with a random filter per row, every type present."""
    rng = np.random.RandomState(channels)
    h, w = 23, 31
    rows = rng.randint(0, 256, (h, 1 + w * channels)).astype(np.uint8)
    rows[:, 0] = rng.permutation(np.arange(h) % 5)
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    want = _unfilter_loop(rows, channels).reshape(h, w, channels)
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7, 3), (9, 1, 4), (5, 6, 2)])
@pytest.mark.parametrize("filter_type", range(5))
def test_write_png_round_trip_edges(tmp_path, shape, filter_type):
    x = np.random.RandomState(filter_type).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "e.png"), x, filter_type)
    got = decode_png(open(tmp_path / "e.png", "rb").read())
    np.testing.assert_array_equal(got.reshape(x.shape), x)
    np.testing.assert_array_equal(np.asarray(imageio.imread(tmp_path / "e.png")).reshape(x.shape), x)


def _interlaced(path):
    """A valid PNG's IHDR with the interlace byte set (CRC recomputed)."""
    write_png(str(path), _image(8, 8))
    data = bytearray(open(path, "rb").read())
    ihdr = bytes(data[12:29])
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    assert ihdr != bytes(data[12:29])
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("kind,match", [("16bit", "bit depth 16"), ("palette", "colour type 3"),
                                        ("interlaced", "interlaced")])
def test_read_png_rejects(tmp_path, kind, match):
    path = tmp_path / f"{kind}.png"
    if kind == "16bit":
        cv2.imwrite(str(path), (np.arange(48).reshape(4, 4, 3) * 1000).astype(np.uint16))
    elif kind == "palette":
        Image.fromarray(_image(8, 8)).convert("P").save(path)
    else:
        _interlaced(path)
    with pytest.raises(ValueError, match=match):
        read_png(str(path))


def _cv2_resize(x, h, w, interp):
    out = cv2.resize(x, (w, h), interpolation=interp)
    return out if out.ndim == 3 else out[..., None]


@pytest.mark.parametrize("src,dst", [((375, 1242), (256, 832)), ((480, 640), (256, 320)),
                                     ((100, 150), (64, 96)), ((128, 192), (64, 96)),
                                     ((50, 150), (64, 96)), ((100, 60), (64, 96))])
def test_resize_area_equals_cv2(src, dst):
    """Shrinks (fractional and integer scales) and the mixed cases, where
    OpenCV emulates area with two taps."""
    x = (np.random.RandomState(0).rand(*src, 3) * 255).astype(np.float32)
    got = resize_area(torch.from_numpy(x), *dst).numpy()
    assert np.abs(got - _cv2_resize(x, *dst, cv2.INTER_AREA)).max() <= AREA_TOL


@pytest.mark.parametrize("src,dst,scale", [((200, 600), (256, 832), 255.0),
                                           ((64, 96), (100, 150), 255.0),
                                           ((256, 832), (375, 1242), 1.0),
                                           ((128, 192), (64, 96), 255.0)])
def test_resize_linear_equals_cv2(src, dst, scale):
    x = (np.random.RandomState(1).rand(*src, 3) * scale).astype(np.float32)
    got = resize_linear(torch.from_numpy(x), *dst).numpy()
    want = _cv2_resize(x, *dst, cv2.INTER_LINEAR)
    assert np.abs(got - want).max() <= LINEAR_TOL * scale / 255.0


def test_resize_leading_dims_and_selection():
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 30, 40, 3).astype(np.float32))
    np.testing.assert_array_equal(resize_area(x, 20, 25)[1].numpy(), resize_area(x[1], 20, 25).numpy())
    assert resize_like_cv2(x, 30, 40) is x
    np.testing.assert_array_equal(resize_like_cv2(x, 20, 50).numpy(), resize_area(x, 20, 50).numpy())
    np.testing.assert_array_equal(resize_like_cv2(x, 60, 50).numpy(), resize_linear(x, 60, 50).numpy())


@pytest.mark.parametrize("src,dst,tol", [((100, 150), (64, 96), AREA_TOL),
                                         ((375, 1242), (256, 832), AREA_TOL),
                                         ((40, 60), (64, 96), LINEAR_TOL),
                                         ((200, 600), (256, 832), LINEAR_TOL),
                                         ((64, 96), (64, 96), 0.0)])
@pytest.mark.parametrize("mode", ["rgb", "grey", "rgba"])
def test_load_image_against_jax(tmp_path, src, dst, tol, mode):
    """Area shrinks within 1e-3 grey levels (measured 4.6e-5 at 375x1242 ->
    256x832), linear growth within 2e-2 (measured 5.3e-3 at 200x600 ->
    256x832, 0 at the exact 1.6x of 40x60 -> 64x96), the network size
    exactly."""
    path = str(tmp_path / "img.png")
    imageio.imwrite(path, _as_mode(_image(*src, seed=3), mode))
    want = jinf.load_image(path, *dst)
    got = pinf.load_image(path, *dst).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= tol
    np.testing.assert_array_equal(pinf.load_image(path).numpy(), jinf.load_image(path))


def test_batched_equals_jax(tmp_path):
    """Batches and their padding (the last frame repeated) as JAX's, for
    frames at the network size and for frames that shrink."""
    paths = []
    for i, hw in enumerate([(64, 96)] * 3 + [(100, 150)] * 2):
        paths.append(str(tmp_path / f"{i}.png"))
        imageio.imwrite(paths[-1], _image(*hw, seed=i))
    got = list(pinf.batched(paths, 2, 64, 96))
    want = list(jinf.batched(paths, 2, 64, 96))
    assert [n for _, n in got] == [n for _, n in want] == [2, 2, 1]
    frames = [i for i in range(5) for _ in range(2 if i == 4 else 1)]  # 4 is repeated
    for k, ((g, _), (w, _)) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2, 64, 96, 3)
        for j in range(2):
            src = frames[2 * k + j]
            err = np.abs(g[j].numpy() - w[j]).max()
            # an error of e grey levels is e / 255 / 0.225 after normalizing
            assert err <= (0.0 if src < 3 else AREA_TOL / 255 / 0.225), (k, j, err)
    np.testing.assert_array_equal(got[2][0][0].numpy(), got[2][0][1].numpy())


def test_normalize_matches_jax():
    x = (np.random.RandomState(4).rand(5, 7, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(pinf.normalize(torch.from_numpy(x)).numpy(), jinf.normalize(x))


def test_other_formats_go_through_imageio(tmp_path):
    img = _image(16, 24)
    imageio.imwrite(tmp_path / "x.bmp", img)
    np.testing.assert_array_equal(pinf.read_image(str(tmp_path / "x.bmp")), img)
    pinf.write_image(str(tmp_path / "y.bmp"), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(tmp_path / "y.bmp")), img)
