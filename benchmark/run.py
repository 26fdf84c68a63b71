"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Set-up (data, networks, the first dispatches, counted in ``setup_s``), a
window of ``--seconds`` in which the port trains, then, with ``--trace 1``,
a few profiled dispatches; then the program is freed and the plain
reference follows its first steps from the seed and its first CUDA-graph
replay from the state before it (``check.py``). The last line on standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checked``: each compared number beside its limit, also the last lines on
standard error). Exits non-zero, printing no result, without enough CUDA
cards, without the port, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sc_sfmlearner_release_tpu")
GIB = 2 ** 30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def records(cell: spec.Cell, run: dict) -> dict:
    """What the per-layer readers read (``metrics/*.py``): the family's
    launch shapes and each of its kernels' bytes at them, and its own
    kernel-name groups (``families/<family>/kernels.py``)."""
    cfg, traffic = cell.config, cell.traffic
    kernels = spec.family(cfg["family"], "kernels")
    shapes = dict(kernels.shapes(cfg, traffic),
                  global_batch=cfg["batch_size"] * traffic.get("world_size", 1))
    return {"config": cfg, "traffic": traffic, "chips": cell.chips, "shapes": shapes,
            "kernel_bytes": {k: fn(shapes) for k, fn in kernels.KERNEL_BYTES.items()},
            "groups": getattr(kernels, "GROUPS", ()),
            "window": run["window"], "trace": run["trace"]}


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            start: float = PROCESS_START, root: str = spec.ROOT) -> dict:
    """One run in this process: the program's set-up, window and trace,
    then, with the program freed, the reference's first steps and the
    comparison. Returns the result line, ``checked`` last."""
    import torch

    from . import cell as harness
    from . import check, follow
    from . import trace as tracing

    cfg, traffic = cell.config, cell.traffic
    if traffic.get("world_size", 1) > 1:
        from . import ranks

        run = ranks.run(cfg, traffic, seed, seconds, trace, device.type, log)
    else:
        run = harness.run(cfg, traffic, seed, seconds, trace, device, log)
    win = run["window"]
    snippets = win["steps"] * cfg["batch_size"] * traffic.get("world_size", 1)
    setup_s = run["window_start"] - start
    log(f"[window] {win['dispatches']} dispatches, {win['steps']} steps in "
        f"{win['seconds']:.4f} s; setup {setup_s:.3f} s")
    if trace:
        rec = records(cell, run)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"snippets_per_s": snippets / win["seconds"],
                  "peak_mem_gib": run["peak_bytes"] / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(run["peak_bytes"])}
    out = {"correct": False, "attempted": win["dispatches"], "failed": win["failed"],
           "metrics": metrics, "device": info}
    if trace and run["trace"]:
        info["busy_s"] = run["trace"]["busy_s"]
        info["window_s"] = run["trace"]["wall_s"]
        out["breakdown"] = tracing.breakdown(run["trace"], rec["groups"])
    first = run["first"]
    del run
    t = time.perf_counter()
    precision = cell.limits["reference"]
    ref = follow.follow(cfg, traffic, seed, harness.CHECKED_STEPS, device, precision=precision)
    ref["replay"] = follow.follow_from(cfg, traffic, seed, first["replay"], device,
                                       precision=precision)
    log(f"[reference] {time.perf_counter() - t:.3f} s")
    # Each replayed step's loss on both sides, so that a gap names its step
    # and its side.
    log(f"[replay losses] program {json.dumps(first['replay']['losses'])} "
        f"reference {json.dumps(ref['replay']['losses'])}")
    values = check.numbers(first, ref)
    log(f"[numbers] {json.dumps(values)}")
    ok, out["checked"] = check.judge(values, cell.limits["limits"])
    out["correct"] = ok and out["failed"] == 0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(spec.ROOT, "build", sub)
    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import sc_sfmlearner_release_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the port is not importable here: {exc}")
        return 3
    card = card_line()
    log(f"[card] {card}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    checked = out.pop("checked")
    return emit({**out, "card": card, "checked": checked})


def emit(out: dict) -> int:
    found = forbidden_modules()
    if found:
        log(f"refusing to report: the process loaded {found}")
        return 4
    for name, c in out["checked"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
