"""The readers of the program's spans and counters on synthetic records:
a traced window of 1000 us (2 optimizer steps), the program's store of
spans on its own clock with the main thread's copies among the host
records, and four device records with three idle gaps between them."""

import pytest

from benchmark import spans, spec
from sc_sfmlearner_release_tpu_torch.utils import profiling

SHIFT_US = 5e6  # the program's clock runs this far ahead of the trace's
MAIN, W1, W2 = 11, 12, 13
# (name, start_us, end_us, thread, copied) on the trace's clock
STORE = [
    ("data.queue_wait", 10, 210, MAIN, True),
    ("step.wait_turn", 300, 310, MAIN, True),
    ("step.stage", 320, 400, MAIN, True),
    ("data.sample", 50, 250, W1, False),
    ("data.decode", 60, 120, W1, False),
    ("data.decode", 130, 200, W1, False),
    ("data.sample", 900, 1200, W1, False),  # runs past the window: 100 us in it
    ("data.sample", 100, 400, W2, False),
    ("data.decode", 110, 150, W2, False),
]
KERNELS = [("a", 0, 100), ("b", 220, 300), ("c", 305, 600), ("d", 650, 700)]
HOST = [
    ("bench.data_wait", 0, 300), ("bench.dispatch", 300, 1000),
    ("cudaMemcpyAsync", 40, 50),  # while "a" runs: no gap
    ("cudaLaunchKernel", 215, 218),  # begins in the gap 100-220: the host's
    ("cudaGraphLaunch", 250, 660),  # blocked across 300-305 and 600-650: no gap
    ("cudaEventSynchronize", 300, 304),  # inside 300-305, but enqueues nothing
    ("cuLaunchKernel", 645, 648),  # begins in the gap 600-650: the host's
] + [(profiling.COPY + n, s, e) for n, s, e, _, copied in STORE if copied]
COUNTERS = {"step.graph_kernels": 1184 * 16, "setup.warm_s": 2.5, "setup.capture_s": 1.25}

EXPECTED = {
    "data.queue_wait_ms": 200 / 1e3 / 2,
    "data.sample_ms": (200 + 100 + 300) / 1e3 / 2,
    "data.decode_ms": (60 + 70 + 40) / 1e3 / 2,
    "data.workers_busy_pct": 100.0 * (200 + 100 + 300) / (8 * 1000),
    "step.wait_turn_ms": 10 / 1e3 / 2,
    "step.stage_ms": 80 / 1e3 / 2,
    "step.graph_kernels": 1184.0,
    "setup.warm_s": 2.5,
    "setup.capture_s": 1.25,
    "device.idle_host_pct": 100.0 * (120 + 50) / 700,
    "device.idle_data_pct": 100.0 * 110 / 700,
}


def _rec(trace=True):
    t = {"kernels": KERNELS, "host": HOST, "steps": 2, "wall_s": 1e-3} if trace else None
    return {"config": {"fused_steps": 16}, "traffic": {"workers": 8}, "trace": t}


def _store(entries=STORE):
    return [profiling.Span(n, (s + SHIFT_US) * 1e3, (e + SHIFT_US) * 1e3, thread, i, None, 0,
                           copied)
            for i, (n, s, e, thread, copied) in enumerate(entries)]


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "spans", _store())
    monkeypatch.setattr(profiling.RECORDER, "counters", dict(COUNTERS))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_on_synthetic_records(recorded, metric):
    assert spec.reader(metric)(_rec()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_reads_nothing_without_its_records(monkeypatch, metric):
    monkeypatch.setattr(profiling.RECORDER, "spans", [])
    monkeypatch.setattr(profiling.RECORDER, "counters", {})
    read = spec.reader(metric)
    assert read(_rec(trace=False)) is None
    if metric != "device.idle_host_pct":  # the device and host records alone
        assert read(_rec()) is None


def test_the_idle_rule():
    """A gap counts as the host's where an enqueueing call begins or returns
    inside it; a launch blocked across two gaps and a synchronize inside
    one do not."""
    assert spans.host_gaps(_rec()) == [(100, 220), (600, 650)]
    assert spans.host_gaps({"trace": {"kernels": [], "host": HOST}}) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    assert spans.aligned(_rec()) is None and spans.counter("setup.warm_s") is None
    for metric in EXPECTED:
        if metric != "device.idle_host_pct":
            assert spec.reader(metric)(_rec()) is None, metric


def test_spans_and_counters_carried_from_another_process(monkeypatch):
    """A rank's spans and counters, put into its trace record where they
    were recorded (``spans.carry``), are what the readers read in the
    process that reports, whose own recorder holds nothing."""
    monkeypatch.setattr(profiling.RECORDER, "spans", _store())
    monkeypatch.setattr(profiling.RECORDER, "counters", dict(COUNTERS))
    rec = _rec()
    spans.carry(rec)
    monkeypatch.setattr(profiling.RECORDER, "spans", [])
    monkeypatch.setattr(profiling.RECORDER, "counters", {})
    for metric, value in EXPECTED.items():
        assert spec.reader(metric)(rec) == pytest.approx(value), metric
