"""Part 3 — automatic gradient sync (``src/Part 3/main.py``): the model
runs inside ``DistributedDataParallel``, whose bucketed all-reduce
overlaps the backward pass; each rank keeps its own BatchNorm batch
statistics (running statistics are averaged after each step, as in
JAX)."""

from tpudp_torch.cli import run_part


def main(argv=None):
    return run_part("auto",
                    "Part 3: DP with automatic (compiler-scheduled) grad "
                    "sync", argv=argv)


if __name__ == "__main__":
    main()
