"""``prefill_mfu``: the model FLOPs of the window's prefill batches
(:func:`.flops.prefill_flops`), over the window's length and the bf16 peak
of one H100 (989 TFLOP/s), %."""

from gale_bench.metrics.flops import prefill_flops


def read(run):
    if run.kind != "prefill" or run.peak_flops is None:
        return None
    w = run.window
    work = sum(prefill_flops(run.shape, B, S) for B, S in w["batches"])
    return 100.0 * work / w["window_s"] / run.peak_flops
