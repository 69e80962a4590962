"""``python -m tpudp_torch.analysis`` — ``lint``, ``audit``, ``budget``,
``protocol`` and the ``check`` umbrella: the port's counterpart of
``tpudp/analysis/cli.py``, with its exit codes: 0 clean, 1 on a finding
(a lint finding, an audit mismatch, a protocol violation), 2 on a path
that does not exist or a lock that cannot be read.  ``check`` composes
its gates' codes (2 beats 1 beats 0).

``lint`` and ``protocol`` are stdlib only; ``audit`` and ``budget`` run
the pinned programs on the CPU (torch on one thread, the multi-rank
programs in one spawned gloo world), so the committed lock does not
depend on the host or on a card being attached.
"""

from __future__ import annotations

import argparse
import os
import sys

from .audit import LOCK_PATH, repo_root

#: What ``lint`` and ``check`` lint when no paths are given.
LINT_PATHS = ("tpudp_torch",)


def _missing(paths) -> list:
    root = repo_root()
    return [p for p in paths if not os.path.exists(
        p if os.path.isabs(p) else os.path.join(root, p))]


def _cmd_lint(args) -> int:
    from .core import lint_paths
    from .rules import RULES

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.name}: {rule.summary}")
        return 0
    paths = args.paths or list(LINT_PATHS)
    missing = _missing(paths)
    if missing:  # a typo'd path must not pass by linting nothing
        print(f"error: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    findings, errors = lint_paths(paths, repo_root())
    for err in errors:
        print(f"error: {err}", file=sys.stderr)
    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"tpudp_torch.analysis lint: {n} finding{'s' if n != 1 else ''} "
          f"({len(errors)} parse error{'s' if len(errors) != 1 else ''})")
    return 1 if findings or errors else 0


def _read_lock(rel: str):
    """``(lock, rc)``: the lock, or None and the exit code after a
    diagnosis (2: missing or corrupt)."""
    from . import audit

    try:
        return audit.load_lock(os.path.join(repo_root(), rel)), 0
    except FileNotFoundError:
        print(f"error: no lock at {rel} — run `python -m "
              f"tpudp_torch.analysis audit --update` and commit it",
              file=sys.stderr)
    except (OSError, ValueError) as exc:  # JSONDecodeError is a ValueError
        print(f"error: unreadable lock {rel} ({type(exc).__name__}: {exc})"
              f" — fix it (a merge conflict?) or regenerate it with "
              f"`audit --update`", file=sys.stderr)
    return None, 2


def _cmd_audit(args) -> int:
    from . import audit

    lock = None
    if not args.update:
        lock, rc = _read_lock(args.lock)  # before the capture's seconds
        if lock is None:
            return rc
    current = audit.capture()
    if args.update:
        audit.write_lock(os.path.join(repo_root(), args.lock), current)
        print(f"tpudp_torch.analysis audit: lock updated "
              f"({len(current['programs'])} programs) -> {args.lock}")
        return 0
    problems, notes = audit.compare(lock, current)
    for line in notes + problems:
        print(line)
    if problems:
        print(f"tpudp_torch.analysis audit: {len(problems)} mismatch"
              f"{'es' if len(problems) != 1 else ''} against {args.lock} "
              f"— if the change is intended, regenerate with --update and "
              f"commit the diff")
        return 1
    print(f"tpudp_torch.analysis audit: {len(current['programs'])} step "
          f"programs match {args.lock}")
    return 0


def _cmd_budget(args) -> int:
    from . import audit, budget

    lock, rc = _read_lock(args.lock)
    if lock is None:
        return rc
    if args.table:
        print(budget.render_table(lock["programs"]))
        if not budget.lock_has_ledgers(lock):
            print("tpudp_torch.analysis budget: the lock is not "
                  "budget-complete — regenerate it with `audit --update`")
            return 1
        return 0
    current = audit.capture()
    metrics = (tuple(budget.BUDGET_TOLERANCES)
               if lock.get("torch") == current["torch"]
               else budget.VERSION_NEUTRAL)
    problems = [p for name, rec in current["programs"].items()
                for p in budget.compare_budgets(
                    name, lock["programs"].get(name, {}).get("budget"),
                    rec["budget"], metrics)]
    for p in problems:
        print(p)
    if problems:
        print(f"tpudp_torch.analysis budget: {len(problems)} budget "
              f"mismatch{'es' if len(problems) != 1 else ''} against "
              f"{args.lock}")
        return 1
    print(f"tpudp_torch.analysis budget: {len(current['programs'])} "
          f"program ledgers within tolerance of {args.lock}")
    return 0


def _cmd_protocol(args) -> int:
    from .protocol import (PROTOCOL_MODULES, explore_vote_machine,
                           extract_vote_spec, verify_paths)

    root = repo_root()
    paths = args.paths or ["tpudp_torch"]
    missing = _missing(paths)
    if missing:
        print(f"error: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings, errors = verify_paths(paths, root)
    for err in errors:
        print(f"error: {err}", file=sys.stderr)
    for f in findings:
        print(f.render())
    rc = 1 if findings or errors else 0
    n = len(findings)
    print(f"tpudp_torch.analysis protocol: {n} finding"
          f"{'s' if n != 1 else ''} over the multi-process modules "
          f"({len(PROTOCOL_MODULES)} in scope)")
    if not args.no_model_check:
        # The vote/park machine, its spec extracted from the live
        # resilience source: deleting the completion park or the bounded
        # timeout fails here.
        res_path = os.path.join(root, "tpudp_torch", "resilience.py")
        try:
            with open(res_path, encoding="utf-8") as f:
                spec = extract_vote_spec(f.read(), n_hosts=args.hosts,
                                         max_faults=2, max_crashes=1)
        except OSError as exc:
            print(f"error: cannot read {res_path}: {exc}", file=sys.stderr)
            return 2
        result = explore_vote_machine(spec)
        if result["violations"]:
            for v in result["violations"][:8]:
                print(f"vote machine {v['kind']}: {v['detail']} "
                      f"[state {v['state']}]")
            print(f"tpudp_torch.analysis protocol: vote state machine has "
                  f"{len(result['violations'])} violation(s) within bounds "
                  f"(ranks={spec.n_hosts}, faults<=2/rank, crashes<=1; "
                  f"extracted spec: completion_park={spec.completion_park}, "
                  f"bounded_timeout={spec.bounded_timeout})")
            rc = max(rc, 1)
        else:
            print(f"tpudp_torch.analysis protocol: vote state machine "
                  f"deadlock-free within bounds ({result['states']} states; "
                  f"ranks={spec.n_hosts}, faults<=2/rank, crashes<=1)")
        if not (spec.completion_park and spec.bounded_timeout):
            rc = max(rc, 1)
    return rc


def _cmd_check(args) -> int:
    """lint, protocol, then audit (with the budget ledgers): the codes
    composed — 2 beats 1 beats 0."""
    ns = argparse.Namespace
    rcs = []
    print("== lint ==")
    rcs.append(_cmd_lint(ns(paths=list(LINT_PATHS), list_rules=False)))
    print("== protocol ==")
    rcs.append(_cmd_protocol(ns(paths=["tpudp_torch"], no_model_check=False,
                                hosts=3)))
    print("== audit (census + budget ledgers) ==")
    rcs.append(_cmd_audit(ns(update=False, lock=args.lock)))
    status = ", ".join(f"{n}={'ok' if c == 0 else f'FAIL({c})'}"
                       for n, c in zip(("lint", "protocol", "audit+budget"),
                                       rcs))
    print(f"tpudp_torch.analysis check: {status}")
    return max(rcs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpudp_torch.analysis",
        description="the port's hazard linter, step-program audit and "
                    "cross-rank protocol verifier")
    sub = parser.add_subparsers(dest="cmd", required=True)
    lint = sub.add_parser(
        "lint", help="the hazard rules over the given paths (default: "
                     "tpudp_torch/); nonzero on an unsuppressed finding")
    lint.add_argument("paths", nargs="*",
                      help="files/directories, relative to the repo root")
    lint.add_argument("--list-rules", action="store_true",
                      help="print the rule catalogue and exit")
    lint.set_defaults(fn=_cmd_lint)
    aud = sub.add_parser(
        "audit", help="run the registered step programs at their pinned "
                      "CPU geometries and diff their census against the "
                      f"lock ({LOCK_PATH})")
    aud.add_argument("--update", action="store_true",
                     help="regenerate the lock from the current tree")
    aud.add_argument("--lock", default=LOCK_PATH,
                     help="lock path relative to the repo root")
    aud.set_defaults(fn=_cmd_audit)
    bud = sub.add_parser(
        "budget", help="diff the per-program resource ledgers against "
                       "the lock; --table prints the committed ledgers")
    bud.add_argument("--lock", default=LOCK_PATH,
                     help="lock path relative to the repo root")
    bud.add_argument("--table", action="store_true",
                     help="print the committed ledger table and exit "
                          "(runs nothing)")
    bud.set_defaults(fn=_cmd_budget)
    proto = sub.add_parser(
        "protocol", help="path-sensitive cross-rank protocol verifier "
                         "over the multi-process modules (rank-uniform "
                         "collective sequences) + bounded vote-machine "
                         "model check; stdlib-only")
    proto.add_argument("paths", nargs="*",
                       help="files/directories, relative to the repo root "
                            "(default: tpudp_torch/)")
    proto.add_argument("--no-model-check", action="store_true",
                       help="skip the vote state-machine exploration")
    proto.add_argument("--hosts", type=int, default=3,
                       help="rank count bound for the interleaving "
                            "explorer (default 3)")
    proto.set_defaults(fn=_cmd_protocol)
    chk = sub.add_parser(
        "check", help="lint + protocol + audit (with the budget ledgers), "
                      "nonzero if any gate fails")
    chk.add_argument("--lock", default=LOCK_PATH,
                     help="lock path relative to the repo root")
    chk.set_defaults(fn=_cmd_check)
    args = parser.parse_args(argv)
    return args.fn(args)
