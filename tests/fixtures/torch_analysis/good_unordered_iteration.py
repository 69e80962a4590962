"""The corrected twin: sorted first."""
# tpudp: collective-module

import os


def leaves(names, root):
    out = []
    for name in sorted(set(names)):
        out.append(name)
    keys = [k for k in sorted({"b", "a"})]
    files = sorted(os.listdir(root))
    return out, keys, files
