"""``moe_scatter_share.prefill``: the device time of the kernels the MoE's
``index_add_`` scatters launch (dispatch into the expert buffer, the
experts' rows back), over the device's busy time in the traced window, %."""

OP = "aten::index_add_"


def read(run):
    if run.kind != "prefill" or run.trace is None:
        return None
    spent = run.trace["op_device_s"].get(OP, 0.0)
    if spent <= 0:
        return None
    return 100.0 * spent / run.trace["busy_s"]
