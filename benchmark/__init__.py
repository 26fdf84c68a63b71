"""The benchmark of the PyTorch/CUDA port ``sc_sfmlearner_release_tpu_torch``.

One run trains one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card for a fixed window, prints one JSON line, and
checks the first steps against a plain PyTorch reference:

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: ``configs/<config>.json``, the
configuration's family ``families/<family>/`` (its program, reference, FLOP
count and kernel bytes), ``traffic/<mix>.json``, ``limits/<cell>.json`` and,
for each per-layer metric, ``metrics/<metric>.py``. The yardsticks (peaks,
FLOP and byte counts, kernel groups), the data generator and the references
live here and import nothing of the port.
"""
