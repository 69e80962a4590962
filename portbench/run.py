"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic and metrics come from BENCHMARK.json
and the files it names (``portbench/harness/manifest.py``).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled sub-window at
the end of the window.  The last line of standard output is one JSON
object; the numbers the check compared, each with its limit, close both
that object and standard error.  Needs a CUDA card.
"""

import time

T0_WALL = time.time()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# The bytecode of every module a run imports (PyTorch's among them) is
# kept in the checkout, so that only a checkout's first run compiles it.
sys.pycache_prefix = os.path.join(ROOT, ".portbench_cache", "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    from portbench.harness import manifest

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    from portbench.harness import runner

    rec = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     t0_wall=T0_WALL, marks=[("import_torch", time.time())])
    found = runner.loaded_forbidden()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    out = runner.result(cell, rec, bool(args.trace))
    tr = rec.get("trace") or {}
    print(json.dumps({
        "setup_s": rec.get("setup_s"),
        "setup_parts": rec.get("setup_parts"), "steps": rec.get("steps"),
        "window_s": rec.get("window_s"),
        "memory_peak_bytes": rec["memory_peak_bytes"],
        "trace": {k: tr[k] for k in ("window_s", "busy_s", "device_events",
                                     "ranges") if k in tr}}),
          file=sys.stderr)
    for name, (value, limit) in out["compared"].items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
