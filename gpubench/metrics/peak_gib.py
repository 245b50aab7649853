"""Peak device memory of the window: torch.cuda.max_memory_allocated()
after reset_peak_memory_stats() at its start, in GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
