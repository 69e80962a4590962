"""Seeded violations for host-sync on a marked hot path."""

import torch


class Scheduler:
    # tpudp: hot-path
    def drive(self, state, batch):
        logits = torch.matmul(state, batch)
        score = float(logits.sum())           # finding: per-step read
        best = logits.argmax().item()         # finding: per-step read
        rows = logits.tolist()                # finding: per-step read
        host = logits.cpu()                   # finding: per-step copy
        torch.cuda.synchronize()              # finding: a barrier
        return score, best, rows, host
