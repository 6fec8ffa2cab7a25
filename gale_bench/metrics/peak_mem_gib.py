"""``peak_mem_gib``: the device memory the program's tensors held at most
over set-up and the window (``torch.cuda.max_memory_allocated``), GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
