"""loader_wait_ms.vgg: milliseconds a step the Trainer waited for its
batch from the Prefetcher (the benchmark's span around each draw), over
the unprofiled window."""


def read(run):
    r = run.record
    if r.get("loader_wait_s") is None or not r.get("steps"):
        return None
    return 1e3 * r["loader_wait_s"] / r["steps"]
