"""Seeded violations for use-after-replay."""


def serve(window, values):
    out = window.outputs["out"]
    window.run(values, 4)
    first = out.sum()                 # finding: overwritten by the replay
    counts = window.counts
    window.graph.replay()
    return first, counts[0]           # finding: counters moved on
