"""The port's spans and counters (``utils/profiling.py``): recorded only
under ``torch.profiler``, from any thread, with their profiler copies on the
profiling thread, put on the profiler's clock by ``aligned``, emptied by the
next profile; the loader's spans; and the spans in a ``trace`` file."""

import concurrent.futures
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sc_sfmlearner_release_tpu_torch.data import BatchLoader, SequenceSet
from sc_sfmlearner_release_tpu_torch.utils import profiling, trace
from sc_sfmlearner_release_tpu_torch.utils.profiling import COPY, SPAN_CATEGORY, Recorder


INNER = 4


def _host_records(prof):
    return [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA]


def _work(rec, name, batch=None, seconds=0.002):
    with rec.span(name, batch):
        time.sleep(seconds)
    return threading.get_native_id()


@pytest.fixture
def profiled():
    """A recorder and a profile over main-thread spans (``main.outer`` with
    four ``main.inner`` inside it, batch 3) and, after them, one span on a
    pool thread (``worker.job``, batch 5): (recorder, host records, worker's
    thread id)."""
    rec = Recorder()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with rec.span("main.outer", 3):
                for _ in range(INNER):
                    _work(rec, "main.inner")
            worker = pool.submit(_work, rec, "worker.job", 5).result()
    return rec, _host_records(prof), worker


def test_nothing_is_recorded_without_a_profiler_but_counters_count():
    rec = Recorder()
    with rec.span("main.outer", 1):
        with rec.span("main.inner"):
            pass
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pool.submit(_work, rec, "worker.job", 2, 0.0).result()
    rec.counter("setup.warm_s", 1.5)
    rec.counter("setup.warm_s", 2.5)
    assert rec.spans == [] and not rec.on
    assert rec.counters == {"setup.warm_s": 2.5}
    assert rec.aligned([("sc#main.outer", 0.0, 1.0)]) is None


def test_spans_of_the_main_thread_and_a_worker_are_kept(profiled):
    rec, _, worker = profiled
    assert sorted(s.name for s in rec.spans) == \
        ["main.inner"] * INNER + ["main.outer", "worker.job"]
    spans = {s.name: s for s in rec.spans}  # the last inner span
    outer, inner, job = spans["main.outer"], spans["main.inner"], spans["worker.job"]
    main = threading.get_native_id()
    assert outer.thread == inner.thread == main and job.thread == worker != main
    assert inner.parent == outer.id and outer.parent is None and job.parent is None
    assert (outer.batch, inner.batch, job.batch) == (3, 3, 5)
    assert outer.copied and inner.copied and not job.copied
    assert outer.start < inner.start < inner.end < outer.end < job.start < job.end


def test_copies_appear_in_the_host_records(profiled):
    _, host, _ = profiled
    names = [n for n, _, _ in host if n.startswith(COPY)]
    assert sorted(names) == ["sc#main.inner"] * INNER + ["sc#main.outer"]


def test_aligned_puts_spans_on_the_profilers_clock(profiled):
    rec, host, _ = profiled
    spans = sorted(rec.aligned(host), key=lambda s: s.start)
    copies = sorted((s, n[len(COPY):]) for n, s, _ in host if n.startswith(COPY))
    main = [s for s in spans if s.copied]
    assert [s.name for s in main] == [n for _, n in copies]
    # The profile's first range opens slower; the median shift holds the rest.
    for s, (start, _) in list(zip(main, copies))[1:]:
        assert abs(s.start - start) < 50, (s, start)
    job = spans[-1]
    assert job.name == "worker.job" and job.start > max(s.end for s in main)
    assert job.end - job.start >= 2000  # us


@pytest.mark.parametrize("site_between", [True, False])
def test_the_store_empties_on_the_next_profile(profiled, site_between):
    """With a span site between two profiles (the loader's threads), the
    store empties; with none, ``aligned`` leaves the first profile out."""
    rec = profiled[0]
    if site_between:
        with rec.span("between profiles"):  # recording off: marks the profile stopped
            pass
    assert len(rec.spans) == INNER + 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(INNER):
            _work(rec, "second.profile", 9, 0.001)
    second = [("second.profile", 9)] * INNER
    assert [(s.name, s.batch) for s in rec.spans][-INNER:] == second
    assert len(rec.spans) == (INNER if site_between else 2 * INNER + 2)
    assert [(s.name, s.batch) for s in rec.aligned(_host_records(prof))] == second


def _tiny_tree(root, frames=5, h=32, w=48):
    from PIL import Image

    rng = np.random.RandomState(0)
    k = np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    os.makedirs(os.path.join(root, "s1"))
    for i in range(frames):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "s1", f"{i:07d}.jpg"), quality=90)
    np.savetxt(os.path.join(root, "s1", "cam.txt"), k)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("s1\n")


def test_the_loader_records_samples_decodes_and_queue_waits(tmp_path):
    _tiny_tree(str(tmp_path))
    data = SequenceSet(str(tmp_path), sequence_length=3)  # 3 snippets of 3 frames
    loader = BatchLoader(data, batch_size=1, shuffle=False, num_workers=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = iter(loader)
        next(batches), next(batches)
        batches.close()  # joins the producer: every sample it began has ended
    spans = profiling.RECORDER.spans
    by_name = {n: [s for s in spans if s.name == n]
               for n in ("data.sample", "data.decode", "data.queue_wait")}
    samples = {s.id: s for s in by_name["data.sample"]}
    main = threading.get_native_id()
    # Two batches taken; the producer may have loaded the third before the
    # consumer stopped.
    assert sorted(s.batch for s in by_name["data.queue_wait"]) == [0, 1]
    assert all(s.thread == main and s.copied for s in by_name["data.queue_wait"])
    assert sorted(s.batch for s in samples.values())[:2] == [0, 1] and len(samples) <= 3
    assert all(s.thread != main for s in samples.values())
    assert len(by_name["data.decode"]) == 3 * len(samples)
    for d in by_name["data.decode"]:
        parent = samples[d.parent]
        assert d.thread == parent.thread and d.batch == parent.batch
        assert parent.start <= d.start <= d.end <= parent.end
    offsets = profiling.aligned(_host_records(prof))
    assert offsets is not None and len(offsets) == len(spans)


def test_trace_writes_the_spans_into_its_file(tmp_path):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with trace(str(tmp_path)):
            with profiling.span("test.outer", 4):
                torch.ones(32, 32) @ torch.ones(32, 32)
                time.sleep(0.001)
            worker = pool.submit(_work, profiling.RECORDER, "test.worker", 4).result()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    mine = {e["name"]: e for e in events if e.get("cat") == SPAN_CATEGORY}
    copy = next(e for e in events if e["name"] == "sc#test.outer")
    outer = mine["test.outer"]
    assert abs(outer["ts"] - copy["ts"]) < 50 and outer["tid"] == copy["tid"]
    assert outer["args"]["batch"] == 4
    assert mine["test.worker"]["tid"] == worker != outer["tid"]
    assert mine["test.worker"]["ts"] > outer["ts"] + outer["dur"]
