"""The jobs that drive a traffic kind, one module a kind: ``setup``,
``window``, ``drain``, ``release`` and ``check`` of a run (see
:mod:`gale_bench.harness`)."""
