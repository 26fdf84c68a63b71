"""Port host data against the JAX package's (CPU): the dataset crawlers,
the packed format, the batch loader and the host transforms are the port's
own copies and must give bit-equal batches for the same seed and epoch;
``device_prefetch`` on the CPU.

The JAX package decodes JPEGs through its C++ extension where it is built
(within one grey level of imageio's decoder, ``tests/test_native_io.py``);
the port has no build of it and decodes through imageio. The JAX side is
held to imageio here, so that the comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu import data as jdata
from sc_sfmlearner_release_tpu.data import native_io as jnative_io
from sc_sfmlearner_release_tpu.data import transforms as jtransforms
from sc_sfmlearner_release_tpu_torch import data
from sc_sfmlearner_release_tpu_torch.data import native_io, transforms
from sc_sfmlearner_release_tpu_torch.parallel import device_prefetch


H, W = 24, 40
SCENES = {"s1": 6, "s2": 5, "v1": 5}


@pytest.fixture(autouse=True)
def _jax_decodes_with_imageio(monkeypatch):
    monkeypatch.setattr(jnative_io, "_native", None)


def _write_sequences(root, rng):
    import imageio.v2 as imageio

    for scene, n in SCENES.items():
        d = root / scene
        d.mkdir(parents=True)
        for i in range(n):
            imageio.imwrite(d / f"{i:07d}.jpg", (rng.rand(H, W, 3) * 255).astype(np.uint8),
                            quality=90)
        k = np.array([[30.0 + rng.rand(), 0, W / 2], [0, 31.0, H / 2], [0, 0, 1]])
        np.savetxt(d / "cam.txt", k)
    (root / "train.txt").write_text("s1\ns2\n")
    (root / "val.txt").write_text("v1\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI-format tree of JPEG sequences, with ground truth for the
    validation scene, a NYU-style pair tree, and both packed forms."""
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("seq")
    rng = np.random.RandomState(0)
    _write_sequences(root, rng)
    for i in range(SCENES["v1"]):
        np.save(root / "v1" / f"{i:07d}.npy", rng.uniform(1, 80, (H, W)).astype(np.float32))
    os.makedirs(root / "v1" / "depth")
    for i in range(SCENES["v1"]):
        imageio.imwrite(root / "v1" / "depth" / f"{i:07d}.png",
                        rng.randint(0, 60000, (H, W)).astype(np.uint16))
    pairs = tmp_path_factory.mktemp("pairs")
    for scene in ("p1", "p2"):
        d = pairs / scene
        d.mkdir()
        for i in range(6):
            imageio.imwrite(d / f"{i:04d}.jpg", (rng.rand(H, W, 3) * 255).astype(np.uint8))
        for i in range(3):
            np.savetxt(d / f"{i:04d}.txt", np.diag([20.0 + i, 21.0, 1.0]))
    (pairs / "train.txt").write_text("p1\n")
    (pairs / "val.txt").write_text("p2\n")
    port_packed = data.pack_dataset(str(root), str(root / "packed"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnative_io, "_native", None)
        jax_packed = jdata.pack_dataset(str(root), str(root / "packed_jax"))
    return {"root": str(root), "pairs": str(pairs), "packed": port_packed,
            "packed_jax": jax_packed}


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _rng(i):
    return np.random.default_rng(np.random.SeedSequence([5, i]))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("host_transform", ["train", "valid", "raw", None])
def test_sequence_set_matches_jax(tree, train, host_transform):
    make = lambda mod: {"train": mod.train_transform, "valid": mod.valid_transform,
                        "raw": mod.raw_train_transform}.get(host_transform, lambda: None)()
    got = data.SequenceSet(tree["root"], train=train, transform=make(transforms))
    want = jdata.SequenceSet(tree["root"], train=train, transform=make(jtransforms))
    assert len(got) == len(want) == (7 if train else 3)
    for i in range(len(want)):
        _assert_samples_equal(got.load(i, _rng(i)), want.load(i, _rng(i)))


def test_pair_set_matches_jax(tree):
    for train in (True, False):
        got = data.PairSet(tree["pairs"], train=train, transform=transforms.train_transform())
        want = jdata.PairSet(tree["pairs"], train=train,
                             transform=jtransforms.train_transform())
        assert len(got) == len(want) == 3
        for i in range(len(want)):
            _assert_samples_equal(got.load(i, _rng(i)), want.load(i, _rng(i)))


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
def test_validation_set_matches_jax(tree, dataset):
    got = data.ValidationSet(tree["root"], transforms.valid_transform(), dataset)
    want = jdata.ValidationSet(tree["root"], jtransforms.valid_transform(), dataset)
    assert len(got) == len(want) == SCENES["v1"]
    for i in range(len(want)):
        _assert_samples_equal(got.load(i, _rng(i)), want.load(i, _rng(i)))


def test_packed_files_match_jax(tree):
    with open(os.path.join(tree["packed"], "index.json")) as f:
        got = json.load(f)
    with open(os.path.join(tree["packed_jax"], "index.json")) as f:
        want = json.load(f)
    assert got == want and got["n_frames"] == sum(SCENES.values())
    with open(os.path.join(tree["packed"], "frames.u8"), "rb") as f:
        frames = f.read()
    with open(os.path.join(tree["packed_jax"], "frames.u8"), "rb") as f:
        assert frames == f.read()


@pytest.mark.parametrize("host_transform", ["train", None])
def test_packed_sequence_set_matches_jax(tree, host_transform):
    tf = lambda mod: mod.train_transform() if host_transform else None
    got = data.PackedSequenceSet(tree["packed"], transform=tf(transforms))
    want = jdata.PackedSequenceSet(tree["packed_jax"], transform=tf(jtransforms))
    assert len(got) == len(want) == 7
    for i in range(len(want)):
        sample = got.load(i, _rng(i))
        assert sample["tgt"].dtype == (np.float32 if host_transform else np.uint8)
        _assert_samples_equal(sample, want.load(i, _rng(i)))


def test_packed_val_split_equals_jpeg_validation(tree):
    """The port's CLI validates from the packed val split where the JAX CLI
    decodes the val JPEGs: the batches are the same."""
    got = data.PackedSequenceSet(tree["packed"], train=False,
                                 transform=transforms.valid_transform())
    want = jdata.SequenceSet(tree["root"], train=False,
                             transform=jtransforms.valid_transform())
    assert len(got) == len(want) == 3
    for i in range(len(want)):
        _assert_samples_equal(got.load(i, _rng(i)), want.load(i, _rng(i)))
    loader = lambda mod, ds: mod.BatchLoader(ds, 2, shuffle=False, num_workers=2,
                                             drop_last=False, seed=3)
    batches = list(zip(loader(data, got), loader(jdata, want)))
    assert len(batches) == 2 and int(batches[-1][0]["_n_valid"]) == 1
    for mine, theirs in batches:
        _assert_samples_equal(mine, theirs)


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False), (False, True)])
@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_matches_jax(tree, drop_last, shuffle, workers):
    got_set = data.SequenceSet(tree["root"], transform=transforms.train_transform())
    want_set = jdata.SequenceSet(tree["root"], transform=jtransforms.train_transform())
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=11)
    got = data.BatchLoader(got_set, num_workers=workers, **kw)
    want = jdata.BatchLoader(want_set, num_workers=2, **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for mine, theirs in pairs:
            _assert_samples_equal(mine, theirs)
        assert int(pairs[-1][0]["_n_valid"]) == (3 if drop_last else 1)


def test_batch_loader_raises_a_workers_error():
    class Broken:
        def __len__(self):
            return 4

        def load(self, i, rng):
            raise OSError(f"cannot read sample {i}")

    with pytest.raises(OSError, match="cannot read sample"):
        list(data.BatchLoader(Broken(), 2, num_workers=2))


def test_imageio_missing_names_the_packed_path(tree, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="--packed"):
        native_io.imread_u8(os.path.join(tree["root"], "s1", "0000000.jpg"))
    sample = data.PackedSequenceSet(tree["packed"]).load(0, _rng(0))  # no decoder needed
    assert sample["refs"].shape == (2, H, W, 3)


def test_device_prefetch_on_the_cpu():
    pulled = []

    def batches():
        for i in range(5):
            pulled.append(i)
            yield {"tgt": np.full((2, 3), i, np.uint8), "k": np.full(2, i, np.float32),
                   "_n_valid": np.asarray(2 - i % 2, np.int32)}
        yield {"tgt": np.full((2, 3), 9, np.uint8)}

    it = device_prefetch(batches(), "cpu", size=2)
    first, n_valid = next(it)
    assert pulled == [0, 1, 2]  # two batches ahead of the one taken
    assert n_valid == 2 and isinstance(n_valid, int) and "_n_valid" not in first
    assert first["tgt"].dtype == torch.uint8 and first["k"].dtype == torch.float32
    rest = list(it)
    assert [int(b["tgt"][0, 0]) for b, _ in rest] == [1, 2, 3, 4, 9]
    assert [n for _, n in rest] == [1, 2, 1, 2, None]
    assert all(b["tgt"].device.type == "cpu" for b, _ in rest)
