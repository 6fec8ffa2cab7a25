"""``train_tokens_per_s``: every token trained over the whole window, over
the window's length (host clock; each step ends in a device sync)."""


def read(run):
    if run.kind != "train":
        return None
    return run.window["tokens"] / run.window["window_s"]
