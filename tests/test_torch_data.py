"""Port host data against the JAX package's (CPU): the dataset crawlers,
the packed format, the batch loader and the host transforms are the port's
own copies and must give bit-equal batches for the same seed and epoch;
the batch loader's schedule (samples of the next batches in flight, rows
written by the threads) against a plain sequential reading, its errors and
its early exits; ``device_prefetch`` on the CPU.

The JAX package decodes JPEGs through its C++ extension where it is built
(within one grey level of imageio's decoder, ``tests/test_native_io.py``);
the port decodes through its own codec (``data/jpeg_io.py``), which equals
imageio's decoder (``tests/test_torch_jpeg.py``). The JAX side is held to
imageio here, so that the comparison is exact.
"""

import json
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu import data as jdata
from sc_sfmlearner_release_tpu.data import native_io as jnative_io
from sc_sfmlearner_release_tpu.data import transforms as jtransforms
from sc_sfmlearner_release_tpu_torch import data
from sc_sfmlearner_release_tpu_torch.data import native_io, transforms
from sc_sfmlearner_release_tpu_torch.data.loader import PREFETCH
from sc_sfmlearner_release_tpu_torch.parallel import device_prefetch
from sc_sfmlearner_release_tpu_torch.utils import profiling


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


class _DrawSet:
    """Samples drawn from their ``rng`` in several dtypes and ranks, each
    load after ``delay`` and a short random sleep, so that the threads
    finish out of order. ``fail`` names an index whose load raises at once;
    every load's thread is recorded."""

    def __init__(self, n, fail=None, delay=0.0):
        self.n, self.fail, self.delay = n, fail, delay
        self.threads = set()
        self.started = 0
        self._lock = threading.Lock()

    def __len__(self):
        return self.n

    def load(self, i, rng):
        with self._lock:
            self.threads.add(threading.current_thread())
            self.started += 1
        if i == self.fail:  # at once, before the samples around it end
            raise OSError(f"cannot read sample {i}")
        time.sleep(self.delay + random.random() * 0.003)
        return {"tgt": rng.random((4, 5, 3), np.float32) + i,
                "refs": rng.integers(0, 256, (2, 4, 5, 3), np.uint8),
                "intrinsics": np.eye(3) * (i + rng.random()),
                "index": np.int32(i)}


def _sequential(ds, batch_size, shuffle, drop_last, seed, epoch, process_index=0,
                process_count=1):
    """The loader's batches read one sample at a time on this thread, in
    the epoch's order, and stacked."""
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    n = len(ds) // batch_size if drop_last else -(-len(ds) // batch_size)
    local = batch_size // process_count
    out = []
    for b in range(n):
        chunk = idx[b * batch_size : (b + 1) * batch_size]
        n_valid = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - n_valid)])
        chunk = chunk[process_index * local : (process_index + 1) * local]
        samples = [ds.load(int(i), np.random.default_rng(np.random.SeedSequence([seed + epoch,
                                                                                  int(i)])))
                   for i in chunk]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["_n_valid"] = np.asarray(n_valid, np.int32)
        out.append(batch)
    return out


def _drain(loader, timeout=60.0):
    """``list(loader)`` on a thread of its own, bounded by ``timeout``."""
    result = {}

    def run():
        try:
            result["batches"] = list(loader)
        except Exception as exc:  # raised again below
            result["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"the loader did not finish within {timeout} s"
    if "error" in result:
        raise result["error"]
    return result["batches"]


@pytest.fixture
def fast_switching():
    """Switch threads every microsecond, so that a lost update would show."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("workers,batch_size,mode,processes", [
    (w, bs, mode, 1) for w in (1, 3, 8) for bs in (3, 4) for mode in ("train", "valid")
] + [(3, 4, "train", 2)])
def test_batch_loader_matches_a_sequential_reading(fast_switching, workers, batch_size, mode,
                                                   processes):
    """Bit-equal batches, ``_n_valid`` included, over two epochs: training
    (shuffled, the partial batch dropped) and validation (in order, the
    last batch padded), and each process's slice of the global batch."""
    ds = _DrawSet(11)
    kw = dict(batch_size=batch_size, shuffle=mode == "train", drop_last=mode == "train",
              seed=2**31 + 7)
    for index in range(processes):
        loader = data.BatchLoader(ds, num_workers=workers, process_index=index,
                                  process_count=processes, **kw)
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            got = _drain(loader)
            want = _sequential(ds, epoch=epoch, process_index=index, process_count=processes,
                               **kw)
            assert len(got) == len(want) == len(loader)
            for mine, theirs in zip(got, want):
                _assert_samples_equal(mine, theirs)
            assert int(got[-1]["_n_valid"]) == (batch_size if mode == "train"
                                                else 11 % batch_size)


def test_batch_loader_loads_across_batch_boundaries():
    """With batches of 2, all 8 threads load at once: samples of the next
    batches are in flight. No timing is asserted."""

    class Sleepy:
        def __init__(self):
            self.lock = threading.Lock()
            self.now = self.most = 0
            self.threads = set()

        def __len__(self):
            return 48

        def load(self, i, rng):
            with self.lock:
                self.now += 1
                self.most = max(self.most, self.now)
                self.threads.add(threading.current_thread())
            time.sleep(0.02)  # releases the GIL, as decode and resize do
            with self.lock:
                self.now -= 1
            return {"x": np.full(3, i, np.int64)}

    ds = Sleepy()
    batches = _drain(data.BatchLoader(ds, 2, num_workers=8, shuffle=False))
    assert [int(b["x"][0, 0]) for b in batches] == list(range(0, 48, 2))
    assert ds.most >= 6  # one batch at a time would load at most 2
    assert len(ds.threads) <= 8
    assert profiling.counters()["data.in_flight_mean"] > 2


@pytest.mark.parametrize("workers", [1, 8])
def test_batch_loader_raises_a_samples_error_in_place_of_its_batch(workers):
    """Index 5 (batch 2 of 2) fails while the batches before it still
    load: batches 0 and 1 come, then the error, and no batch after it."""
    ds = _DrawSet(40, fail=5, delay=0.02)
    loader = data.BatchLoader(ds, 2, num_workers=workers, shuffle=False, seed=3)
    got = []
    with pytest.raises(OSError, match="cannot read sample 5"):
        for batch in loader:
            got.append(batch)
    want = _sequential(_DrawSet(6), 2, False, True, 3, 0)[:2]
    assert len(got) == 2
    for mine, theirs in zip(got, want):
        _assert_samples_equal(mine, theirs)
    assert ds.started < len(ds)  # nothing started after the failure was seen


def test_batch_loader_stops_its_threads_when_left_early():
    """A ``break`` after the first batch starts no more samples and leaves
    no loader thread alive."""
    ds = _DrawSet(400)
    for batch in data.BatchLoader(ds, 2, num_workers=4, shuffle=True, seed=1):
        time.sleep(0.1)  # time for the threads to run up to the staging limit
        break
    for t in ds.threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert 0 < len(ds.threads) <= 4
    # the first batch taken: PREFETCH batches staged and 4 samples beyond
    assert ds.started <= (1 + PREFETCH) * 2 + 4


def test_batch_loader_yields_numpy_arrays_without_pinning():
    ds = _DrawSet(5)
    (batch, _) = list(data.BatchLoader(ds, 2, num_workers=3, pin_memory=False))
    sample = ds.load(0, np.random.default_rng(0))
    assert set(batch) == set(sample) | {"_n_valid"}
    for k, v in sample.items():
        assert type(batch[k]) is np.ndarray and batch[k].dtype == np.asarray(v).dtype, k
        assert batch[k].shape == (2,) + np.shape(v), k
    assert type(batch["_n_valid"]) is np.ndarray and batch["_n_valid"].dtype == np.int32


def test_imageio_missing_names_the_packed_path(tree, monkeypatch, tmp_path):
    """Without imageio, JPEGs still decode (the port's codec, as imageio
    decodes them) and so do PNGs; any other format names the packed path."""
    import sys

    import imageio.v2 as imageio

    jpg = os.path.join(tree["root"], "s1", "0000000.jpg")
    want = np.asarray(imageio.imread(jpg))
    imageio.imwrite(tmp_path / "frame.bmp", want)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(native_io.imread_u8(jpg), want)
    with pytest.raises(ImportError, match="--packed"):
        native_io.imread_u8(str(tmp_path / "frame.bmp"))
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
