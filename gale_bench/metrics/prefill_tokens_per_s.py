"""``prefill_tokens_per_s``: the prompt tokens of every batch served in
the window (a batch's rows have one length: no padding), over the window's
length (host clock; each batch ends with its first tokens on the host)."""


def read(run):
    if run.kind != "prefill":
        return None
    return run.window["tokens"] / run.window["window_s"]
