"""Part 1 — the single-device baseline trainer (``src/Part 1/main.py``):
no gradient synchronization, one device."""

from tpudp_torch.cli import run_part


def main(argv=None):
    return run_part("none", "Part 1: single-device VGG-11/CIFAR-10 baseline",
                    single_device=True, argv=argv)


if __name__ == "__main__":
    main()
