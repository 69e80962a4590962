"""Part 2a — coordinator-style gradient sync (``src/Part 2a/main.py``):
every rank all-gathers the gradients and takes their mean."""

from tpudp_torch.cli import run_part


def main(argv=None):
    return run_part("coordinator",
                    "Part 2a: DP with coordinator-style grad sync",
                    argv=argv)


if __name__ == "__main__":
    main()
