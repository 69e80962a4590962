"""setup_s: seconds from the process's start to the window's first step
(imports, the card lock, the build cache, weights, data and warm-up)."""


def read(run):
    return run.record.get("setup_s")
