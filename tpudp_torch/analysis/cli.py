"""``python -m tpudp_torch.analysis protocol [paths]`` — the port's
counterpart of ``tpudp/analysis/cli.py``'s ``protocol`` subcommand, with
its exit codes: 0 clean, 1 on a finding (or a vote machine that is not
deadlock-free), 2 on a path that does not exist or an unreadable
resilience source.  Stdlib only."""

from __future__ import annotations

import argparse
import os
import sys


def repo_root() -> str:
    """The checkout holding this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _cmd_protocol(args) -> int:
    from .protocol import (PROTOCOL_MODULES, explore_vote_machine,
                           extract_vote_spec, verify_paths)

    root = repo_root()
    paths = args.paths or ["tpudp_torch"]
    missing = [p for p in paths if not os.path.exists(
        p if os.path.isabs(p) else os.path.join(root, p))]
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpudp_torch.analysis",
        description="the cross-rank protocol verifier of the port's "
                    "multi-process modules")
    sub = parser.add_subparsers(dest="cmd", required=True)
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
    args = parser.parse_args(argv)
    return args.fn(args)
