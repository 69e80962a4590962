"""peak_mem_gib: the most memory PyTorch allocated on the card over
set-up and window."""


def read(run):
    peak = run.record["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
