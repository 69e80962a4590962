"""Seeded violations for unordered-iteration."""
# tpudp: collective-module

import os


def leaves(names, root):
    out = []
    for name in set(names):                   # finding: set order
        out.append(name)
    keys = [k for k in {"b", "a"}]            # finding: set literal
    files = os.listdir(root)                  # finding: unsorted listing
    return out, keys, files
