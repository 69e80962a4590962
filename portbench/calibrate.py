"""Readings for setting a cell's limits: the program's on many seeds, the
control's (the reference at the precision below the configuration's)
and each planted fault's, all in one process and without a measured
window.

    python portbench/calibrate.py --workload <name> --seeds 11,12,13 \\
        --fault-seeds 21,22,23 --faults half_batch,unchanged

Prints one JSON line a task and writes them to
``chiprun_out/calibrate-<name>.jsonl``.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from portbench.harness import manifest, runner

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    control = cell["config"]["control"]
    tasks = [{"seed": int(s), "precisions": ["fp32", control]}
             for s in args.seeds.split(",") if s]
    tasks += [{"seed": int(s), "fault": f}
              for f in args.faults.split(",") if f
              for s in args.fault_seeds.split(",") if s]
    t0 = time.time()
    rec = runner.run(cell, 0, 0.0, False, t0_wall=t0, check_only=True,
                     tasks=tasks)
    out = os.path.join(ROOT, "chiprun_out", f"calibrate-{args.workload}.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        for task in rec["tasks"]:
            line = {k: task.get(k) for k in
                    ("seed", "fault", "numbers", f"control_{control}")}
            line["memory_peak_bytes"] = task["memory_peak_bytes"]
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    print(f"calibrate: {len(tasks)} tasks in {time.time() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
