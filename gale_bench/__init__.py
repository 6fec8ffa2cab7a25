"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout::

    python3 -m gale_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or cell
sits in files of its own, found by the name ``BENCHMARK.json`` gives
(:mod:`gale_bench.registry`): ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``, ``limits/<cell>.json``,
``reference/<module>.py`` and ``jobs/<kind>.py``. See ``README.md``.
"""
