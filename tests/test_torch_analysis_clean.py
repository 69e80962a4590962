"""Tier-1 pins: the port satisfies its own analysis.

  * ``lint``: no unsuppressed finding over ``tpudp_torch`` — every
    designed host sync or rendezvous is a visible ``# tpudp:
    lint-ok(rule): reason``;
  * ``audit``: the registered step programs' census (kernel calls, host
    reads, collectives, and, under the lock's torch, the operator
    fingerprint) and their budget ledgers match the committed
    ``tpudp_torch/analysis/program_lock.json``;
  * the lock's source digests are fresh, and every program has a
    ledger.

After an intended change to a pinned hot path: ``python -m
tpudp_torch.analysis audit --update``, and commit the lock diff.
"""

import os

import pytest
import torch

from tpudp_torch.analysis import audit, budget
from tpudp_torch.analysis.core import lint_paths


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, audit.LOCK_PATH)


def test_lint_clean_over_tpudp_torch():
    findings, errors = lint_paths(["tpudp_torch"], ROOT)
    assert errors == [], errors
    assert findings == [], "\n".join(f.render() for f in findings) + (
        "\n\nfix the hazard, or justify it with an explicit "
        "`# tpudp: lint-ok(rule): why`")


@pytest.fixture(scope="module")
def current():
    return audit.capture()


def test_audit_matches_committed_lock(current):
    problems, notes = audit.compare(audit.load_lock(LOCK), current)
    assert problems == [], "\n".join(notes + problems) + (
        "\n\nif the change is intended: `python -m tpudp_torch.analysis "
        "audit --update` and commit the lock diff")


def test_budget_ledgers_within_tolerance(current):
    lock = audit.load_lock(LOCK)
    assert budget.lock_has_ledgers(lock)
    metrics = (tuple(budget.BUDGET_TOLERANCES)
               if lock["torch"] == current["torch"]
               else budget.VERSION_NEUTRAL)
    problems = [p for name, rec in current["programs"].items()
                for p in budget.compare_budgets(
                    name, lock["programs"].get(name, {}).get("budget"),
                    rec["budget"], metrics)]
    assert problems == [], "\n".join(problems)


def test_sources_fresh():
    assert audit.sources_stale(audit.load_lock(LOCK), ROOT) == []
