"""Seeded violations for unregistered-program."""
# tpudp: program-module

import torch


def make_shadow_train_step(model):           # finding: unpinned factory
    def step(state, x):
        return model(x)
    return step


class Engine:
    def _device(self, kind, fn, *args):
        return fn(*args)

    def capture(self, g, fn):
        with torch.cuda.graph(g):            # finding: unpinned capture
            fn()

    def go(self, fn):
        return self._device("shadow", fn)     # finding: unknown kind
