"""``idle_share.prefill``: the share of the traced prefill window in which
no operation ran on the device (:func:`.peaks.idle_share`), %."""

from gale_bench.metrics.peaks import idle_share


def read(run):
    if run.kind != "prefill" or run.trace is None \
            or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * idle_share(run.trace["busy_s"], run.window["window_s"])
