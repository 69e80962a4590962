"""img_per_s: images trained in the window over its wall seconds, a
chip (the window is fenced at its two edges only)."""


def read(run):
    r = run.record
    if not r.get("window_s"):
        return None
    return r["steps"] * r["items_per_step"] / r["window_s"]
