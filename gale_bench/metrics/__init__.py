"""The benchmark's metrics, one module a metric (``read(run)``), and the
frozen arithmetic they share (:mod:`.peaks`, :mod:`.flops`)."""
