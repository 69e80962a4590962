"""Part 2b — all-reduce gradient sync (``src/Part 2b/main.py``):
all_reduce(SUM) / world.  ``--ring`` takes the hand-rolled ring instead,
``--bf16-grads`` a bfloat16 all-reduce, ``--int8-grads`` int8 around the
ring."""

import sys

from tpudp_torch.cli import run_part

RUNG_FLAGS = {"--ring": "ring", "--bf16-grads": "allreduce_bf16",
              "--int8-grads": "allreduce_int8"}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    chosen = [f for f in RUNG_FLAGS if f in argv]
    if len(chosen) > 1:
        raise SystemExit("error: --ring / --bf16-grads / --int8-grads are "
                         "mutually exclusive")
    sync = RUNG_FLAGS[chosen[0]] if chosen else "allreduce"
    return run_part(sync, "Part 2b: DP with all-reduce grad sync",
                    argv=[a for a in argv if a not in RUNG_FLAGS])


if __name__ == "__main__":
    main()
