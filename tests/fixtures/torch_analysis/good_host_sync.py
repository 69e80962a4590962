"""The corrected twin: the device values stay on the device; the one
designed read carries its reason."""

import torch


class Scheduler:
    # tpudp: hot-path
    def drive(self, state, batch):
        logits = torch.matmul(state, batch)
        total = logits.sum()
        n = logits.shape[0]                   # metadata: no sync
        # tpudp: lint-ok(host-sync): the step's one fetch
        toks = logits.argmax(-1).cpu()
        return total, n, toks
