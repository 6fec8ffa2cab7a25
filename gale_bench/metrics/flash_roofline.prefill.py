"""``flash_roofline.prefill``: the least time the card could take for the
window's flash-attention forwards (``flash_fwd_wgmma``: each layer of each
batch, causal, bf16; :func:`.peaks.flash_bound_s` from the shapes), over
the device time of those launches in the trace, %."""

from gale_bench.metrics.peaks import flash_bound_s

KERNEL = "flash_fwd_wgmma"


def read(run):
    if run.kind != "prefill" or run.trace is None:
        return None
    spent = sum(s for name, s in run.trace["kernel_s"].items()
                if KERNEL in name)
    if spent <= 0:
        return None
    c = run.shape
    bound = sum(c.n_layers * flash_bound_s(B, S, S, c.n_heads, c.n_kv_heads,
                                           c.hd, True, "bfloat16")
                for B, S in run.window["batches"])
    return 100.0 * bound / spent
