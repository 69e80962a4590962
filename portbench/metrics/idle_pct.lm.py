"""idle_pct.lm: the share of the profiled sub-window in which nothing
ran on the card, in percent."""


def read(run):
    tr = run.record.get("trace")
    if not tr or not tr["device_events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
