"""``train_mfu``: the model FLOPs of the window's training steps
(:func:`.flops.train_step_flops`), over the window's length and the bf16
peak of one H100 (989 TFLOP/s), %."""

from gale_bench.metrics.flops import train_step_flops


def read(run):
    if run.kind != "train" or run.peak_flops is None:
        return None
    w = run.window
    work = train_step_flops(run.shape, w["batch"], w["seq"]) * w["steps"]
    return 100.0 * work / w["window_s"] / run.peak_flops
