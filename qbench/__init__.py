"""qbench: the benchmark of arrow_tpu_torch, the PyTorch + CUDA port.

One run is one cell of ``BENCHMARK.json`` (a deployment under a query mix):
it makes the cell's tables on the card from ``--seed``, stages them as the
port's Tables, warms up each query kind once, then runs one closed-loop
client for ``--seconds`` whose queries go through
``Declaration.to_table()``, and checks every answer it kept against a plain
reference once the window has closed. Run from the root of a checkout:

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one deployment, mix, query or metric is a file of
its own, found by name (``catalog.py``): ``configs/<config>.json``,
``mixes/<mix>.json``, ``queries/<query>.py``, ``reference/<query>.py``,
``gen/<generator>.py``, ``metrics/<metric>.py``, ``limits/<cell>.json``.
Nothing here imports JAX or the JAX package; the port is imported by
``queries/``, ``stage.py`` and a traced run's node wrapping alone.
"""
