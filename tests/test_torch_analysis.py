"""``tpudp_torch.analysis`` — the port's lint rules, the suppression
machinery, the CLI's exit codes, and the step-program audit.

Every rule fires on its seeded fixture (``tests/fixtures/
torch_analysis/bad_<rule>.py``) the stated number of times and is
silent on the corrected twin (``good_<rule>.py``).  The audit tests
run a few registered programs (and, for the collective census, two
fixture programs in one gloo world of 4) and hold ``compare`` to naming
the program and the field that changed, to reporting a torch version
skew without failing on it, and to flagging stale sources.  The tier-1
pins over the tree live in ``test_torch_analysis_clean.py``.
"""

import copy
import json
import os

import pytest
import torch

from tpudp_torch.analysis import audit
from tpudp_torch.analysis.cli import main as cli_main
from tpudp_torch.analysis.core import lint_paths
from tpudp_torch.analysis.rules import RULES_BY_NAME


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "fixtures", "torch_analysis")
LOCK = os.path.join(ROOT, audit.LOCK_PATH)

RULE_CASES = {
    "capture-nondeterminism": 5,  # clock, random, np.random, rand, uniform_
    "capture-branch": 3,          # if, while, ternary
    "host-sync": 5,               # float, item, tolist, cpu, synchronize
    "use-after-replay": 2,        # output alias, counters alias
    "divergent-collective": 4,    # rank, filesystem, except, derived flag
    "unordered-iteration": 3,     # set loop, set literal, listdir
    "unregistered-program": 3,    # factory, capture, device kind
    "unregistered-kernel": 2,     # unnamed wrapper, uncounted launch
    "obs-in-hot-path": 2,         # .span(), .event()
}


def lint_fixture(name):
    findings, errors = lint_paths([os.path.join(FIXTURES, name)], ROOT)
    assert not errors, errors
    return findings


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_rule_fires_on_seeded_violations(rule):
    findings = lint_fixture(f"bad_{rule.replace('-', '_')}.py")
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) == RULE_CASES[rule], [f.render() for f in findings]
    assert len(findings) == len(hits), [f.render() for f in findings]


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_rule_silent_on_corrected_twin(rule):
    findings = lint_fixture(f"good_{rule.replace('-', '_')}.py")
    assert findings == [], [f.render() for f in findings]


def test_every_rule_has_a_fixture_pair():
    assert set(RULES_BY_NAME) == set(RULE_CASES)
    for rule in RULES_BY_NAME:
        for prefix in ("bad_", "good_"):
            assert os.path.exists(os.path.join(
                ROOT, FIXTURES, f"{prefix}{rule.replace('-', '_')}.py"))


# -- suppressions -------------------------------------------------------------

SYNCY = """\
import torch


# tpudp: hot-path
def drive(x):
    y = torch.exp(x)
    {above}z = y.item(){inline}
    return z
"""


def _lint_source(tmp_path, source):
    p = tmp_path / "mod.py"
    p.write_text(source)
    return lint_paths([str(p)], ROOT)[0]


def test_suppression_same_line(tmp_path):
    assert _lint_source(tmp_path, SYNCY.format(
        above="", inline="  # tpudp: lint-ok(host-sync): test")) == []


def test_suppression_comment_block_above(tmp_path):
    assert _lint_source(tmp_path, SYNCY.format(
        above="# tpudp: lint-ok(host-sync): a reason that spans\n"
              "    # a second comment line\n    ", inline="")) == []


def test_suppression_wrong_rule_does_not_mask(tmp_path):
    rules = {f.rule for f in _lint_source(tmp_path, SYNCY.format(
        above="", inline="  # tpudp: lint-ok(capture-branch): wrong"))}
    assert rules == {"host-sync", "useless-suppression"}


def test_useless_suppression_reported(tmp_path):
    findings = _lint_source(
        tmp_path, "x = 1  # tpudp: lint-ok(host-sync): nothing here\n")
    assert [f.rule for f in findings] == ["useless-suppression"]


# -- the CLI ------------------------------------------------------------------

def test_cli_exit_codes_and_catalogue(capsys, tmp_path):
    assert cli_main(["lint", os.path.join(FIXTURES,
                                          "bad_host_sync.py")]) == 1
    assert cli_main(["lint", os.path.join(FIXTURES,
                                          "good_host_sync.py")]) == 0
    assert "host-sync" in capsys.readouterr().out
    assert cli_main(["lint", "tpudp_torch/no_such_dir"]) == 2
    assert "no such path" in capsys.readouterr().err
    assert cli_main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES_BY_NAME)
    assert cli_main(["budget", "--table"]) == 0
    assert "serve.decode_paged" in capsys.readouterr().out
    bad = tmp_path / "lock.json"
    bad.write_text("<<<<<<< a merge conflict\n")
    for cmd in ("audit", "budget"):
        assert cli_main([cmd, "--lock", str(bad)]) == 2
        assert "unreadable lock" in capsys.readouterr().err
    assert cli_main(["audit", "--lock", str(tmp_path / "none.json")]) == 2


# -- the audit ----------------------------------------------------------------

PINNED = ("serve.decode_paged_kernel@s2m32d64p6", "train.step_single@tiny")


@pytest.fixture(scope="module")
def programs():
    from tpudp_torch.analysis.programs import build_programs

    return {k: v for k, v in build_programs().items() if k in PINNED}


@pytest.fixture(scope="module")
def lock():
    return audit.load_lock(LOCK)


def _subset(lock, names):
    out = copy.deepcopy(lock)
    out["programs"] = {n: lock["programs"][n] for n in names}
    return out


def test_audit_pinned_programs_match_and_mutations_fail_by_name(
        programs, lock):
    """The pinned programs' records equal the lock's; one ``.item()``
    added to a program shows in its ``host_reads``, named."""
    current = audit.capture(programs, rank_world=False)
    assert audit.compare(_subset(lock, PINNED), current)[0] == []
    assert current["programs"][PINNED[0]]["kernels"] == {"paged_decode": 2}
    call, axes = programs[PINNED[1]]

    def mutated():
        out = call()
        out[1].item()  # a new host read on the step's path
        return out

    bad = audit.capture({PINNED[1]: (mutated, axes)}, rank_world=False)
    problems, _ = audit.compare(_subset(lock, [PINNED[1]]), bad)
    assert len(problems) == 1
    assert problems[0].startswith(PINNED[1]) and "host_reads" in problems[0]


def test_audit_collective_added_fails_by_name():
    """The census records each rank's collectives with their axis and
    bytes in one gloo world of 4; a program with one collective more
    fails naming the program and ``collectives``."""
    current = audit.capture_world(extra=["torch_audit_programs:build"],
                                  sys_path=[os.path.join(ROOT, "tests")],
                                  registered=False)
    one = current["fixture.reduce@w4"]
    assert one["collectives"] == [["all_reduce", "data", 32]]
    assert one["p2p"] == [[0, 0, 0, 0]] * 4
    two = current["fixture.reduce_gather@w4"]
    assert two["collectives"] == [["all_reduce", "data", 32],
                                  ["all_gather_into_tensor", "data", 32]]
    lock = {"version": audit.LOCK_VERSION, "torch": torch.__version__,
            "geometry": {}, "sources": {}, "programs": {"p@w4": one}}
    run = dict(lock, programs={"p@w4": two})
    problems, _ = audit.compare(lock, run)
    assert len(problems) == 1 and problems[0].startswith("p@w4")
    assert "collectives" in problems[0]
    assert "collective_payload_bytes 32 -> 64" in problems[0]


def test_audit_missing_and_unpinned_programs_named(lock):
    current = copy.deepcopy(lock)
    gone = next(iter(current["programs"]))
    del current["programs"][gone]
    current["programs"]["serve.new_program@x"] = {}
    problems, _ = audit.compare(lock, current)
    assert any(p.startswith(gone) and "no longer registered" in p
               for p in problems)
    assert any(p.startswith("serve.new_program@x") and "not in the lock" in p
               for p in problems)


def test_audit_update_then_check_roundtrip(programs, tmp_path):
    current = audit.capture(programs, rank_world=False)
    path = tmp_path / "lock.json"
    audit.write_lock(str(path), current)
    assert audit.compare(audit.load_lock(str(path)), current) == ([], [])
    assert json.loads(path.read_text())["torch"] == torch.__version__


def test_audit_torch_skew_reported_not_failed(lock):
    """Another torch dispatches other operators: fingerprint, ops and
    peak live bytes are reported, not compared; a version-neutral field
    still fails."""
    old = copy.deepcopy(lock)
    old["torch"] = "0.0.0+other"
    for rec in old["programs"].values():
        rec["fingerprint"] = "0" * 64
        rec["ops"] += 7
        rec["budget"]["peak_live_bytes"] *= 3
    problems, notes = audit.compare(old, lock)
    assert problems == []
    assert len(notes) == 1 and "0.0.0+other" in notes[0] \
        and lock["torch"] in notes[0]
    name = next(iter(old["programs"]))
    old["programs"][name]["kernels"] = {"paged_tree": 1}
    problems, _ = audit.compare(old, lock)
    assert len(problems) == 1 and problems[0].startswith(name)
    assert "kernels" in problems[0]


def test_audit_stale_sources_reported(lock):
    current = copy.deepcopy(lock)
    rel = next(iter(current["sources"]))
    current["sources"][rel] = "0" * 64
    problems, _ = audit.compare(lock, current)
    assert len(problems) == 1 and "stale source digests" in problems[0]
    assert rel in problems[0]
    stale = copy.deepcopy(lock)
    stale["sources"][rel] = "0" * 64
    assert audit.sources_stale(stale, ROOT) == [rel]
