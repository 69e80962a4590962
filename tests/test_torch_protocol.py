"""The port's protocol verifier and model checkers
(``tpudp_torch.analysis``) on the CPU — the counterpart of the protocol
half of ``tests/test_protocol.py`` (the lock and budget tests have no
counterpart: the jaxpr audit is not ported) and of
``tests/test_disagg.py``'s verifier and model-checker tests.

Every rule fires on JAX's seeded fixtures (``tests/fixtures/analysis/``,
read as they are) with JAX's findings and stays silent on the corrected
twins; the port's multi-process modules verify clean; re-introducing the
reviewed bugs into copies of ``tpudp_torch/resilience.py`` and
``tpudp_torch/serve/disagg.py`` fails the verifier naming the rule and
the mutated line; deleting a load-bearing property from the vote or the
migration spec is caught by the explorer.  The package imports neither
torch nor jax.
"""

import os
import subprocess
import sys

import pytest

from tpudp.analysis.core import PROTOCOL_MODULES as JAX_PROTOCOL_MODULES
from tpudp.analysis.protocol import verify_paths as jax_verify_paths
from tpudp_torch.analysis import PROTOCOL_RULE_NAMES
from tpudp_torch.analysis.cli import main as cli_main
from tpudp_torch.analysis.protocol import (PROTOCOL_MODULES, MigrationSpec,
                                           VoteSpec,
                                           explore_migration_machine,
                                           explore_vote_machine,
                                           extract_migration_spec,
                                           extract_vote_spec, verify_paths)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "fixtures", "analysis")
MARKER = "# tpudp: protocol-module\n"
RESILIENCE = os.path.join("tpudp_torch", "resilience.py")
SEAM = os.path.join("tpudp_torch", "utils", "checkpoint.py")
DISAGG = os.path.join("tpudp_torch", "serve", "disagg.py")


def verify_fixture(name):
    findings, errors = verify_paths([os.path.join(FIXTURES, name)], ROOT)
    assert not errors, errors
    return findings


PROTOCOL_RULE_CASES = {
    "protocol-divergent-entry": 2,   # direct probe + interprocedural
    "protocol-order-divergence": 1,  # swapped vote/barrier across arms
    "protocol-early-exit": 2,        # early return + early raise
    "protocol-divergent-loop": 2,    # for-over-listdir + tainted while
}


@pytest.mark.parametrize("rule", sorted(PROTOCOL_RULE_CASES))
def test_protocol_rule_fires_on_seeded_violations(rule):
    """JAX's bad fixture: the rule fires its pinned number of times, and
    the findings (rule, line) are exactly JAX's verifier's."""
    fname = f"bad_{rule.replace('-', '_')}.py"
    findings = verify_fixture(fname)
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) == PROTOCOL_RULE_CASES[rule], \
        [f.render() for f in findings]
    assert len(findings) == len(hits), [f.render() for f in findings]
    want, _ = jax_verify_paths([os.path.join(FIXTURES, fname)], ROOT)
    assert [(f.rule, f.line) for f in findings] == \
        [(f.rule, f.line) for f in want]


@pytest.mark.parametrize("rule", sorted(PROTOCOL_RULE_CASES))
def test_protocol_rule_silent_on_corrected_twin(rule):
    fname = f"good_{rule.replace('-', '_')}.py"
    findings = verify_fixture(fname)
    assert findings == [], [f.render() for f in findings]


def test_every_protocol_rule_has_fixture_pair():
    assert set(PROTOCOL_RULE_CASES) == set(PROTOCOL_RULE_NAMES)
    for rule in PROTOCOL_RULE_CASES:
        stem = rule.replace("-", "_")
        for prefix in ("bad_", "good_"):
            assert os.path.exists(os.path.join(
                ROOT, FIXTURES, f"{prefix}{stem}.py"))


# -- suppressions and the path machinery --------------------------------


def _paths(tmp_path, source, name="mod.py"):
    p = tmp_path / name
    p.write_text(source)
    return [str(p)]


PROBE = (MARKER
         + "import os\n\n"
           "def resume(root):\n"
           "    {suppress}if os.path.exists(root):\n"
           "        gather_host_values(1)  # noqa: F821\n")


def test_protocol_suppression_masks_finding(tmp_path):
    src = PROBE.format(
        suppress="# tpudp: lint-ok(protocol-divergent-entry): test\n    ")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    src2 = PROBE.format(suppress="")
    src2 = src2.replace(
        "        gather_host_values(1)  # noqa: F821",
        "        # tpudp: lint-ok(protocol-divergent-entry): test\n"
        "        gather_host_values(1)  # noqa: F821")
    findings2, _ = verify_paths(_paths(tmp_path, src2, "mod2.py"), ROOT)
    assert findings2 == [], [f.render() for f in findings2]
    # a suppression above the IF, not the site, masks nothing
    assert sorted(f.rule for f in findings) == [
        "protocol-divergent-entry", "useless-suppression"]


def test_protocol_pass_flags_stale_protocol_suppressions(tmp_path):
    src = (MARKER
           + "def f():\n"
             "    return 1  # tpudp: lint-ok(protocol-early-exit): stale\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert [f.rule for f in findings] == ["useless-suppression"]
    assert "protocol-early-exit" in findings[0].message


def test_identical_label_sequences_compare_equal(tmp_path):
    src = (MARKER
           + "import os\n\n\n"
             "def f(root):\n"
             "    if os.path.exists(root):\n"
             "        gather_host_values(1)  # noqa: F821\n"
             "    else:\n"
             "        gather_host_values(2)  # noqa: F821\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert findings == [], [f.render() for f in findings]


def test_for_loop_target_carries_taint(tmp_path):
    src = (MARKER
           + "import os\n\n\n"
             "def f(root):\n"
             "    d = None\n"
             "    for name in sorted(os.listdir(root)):\n"
             "        d = name\n"
             "    if d:\n"
             "        gather_host_values(1)  # noqa: F821\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert [f.rule for f in findings] == ["protocol-divergent-entry"], \
        [f.render() for f in findings]


def test_truncated_function_is_reported(tmp_path):
    from tpudp_torch.analysis.cfg import MAX_SEQ

    body = "".join(f"    gather_host_values({i})  # noqa: F821\n"
                   for i in range(MAX_SEQ + 4))
    src = MARKER + "def f(root):\n" + body
    findings, errors = verify_paths(_paths(tmp_path, src), ROOT)
    assert errors and "incomplete" in errors[0], (findings, errors)


def test_sibling_ternaries_all_fork(tmp_path):
    src = (MARKER
           + "import os\n\n\n"
             "def f(root, uniform_flag):\n"
             "    local = os.path.exists(root)\n"
             "    return (gather_host_values(1) if uniform_flag"
             " else 0,\n"
             "            all_hosts_ok(True, 0) if local else 1)"
             "  # noqa: F821\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert [f.rule for f in findings] == ["protocol-early-exit"], \
        [f.render() for f in findings]
    assert "all_hosts_ok" in findings[0].message


def test_finally_collectives_cover_exit_paths(tmp_path):
    src = (MARKER
           + "import os\n\n\n"
             "def f(root):\n"
             "    try:\n"
             "        if not os.path.exists(root):\n"
             "            raise RuntimeError('gone')\n"
             "        x = 1\n"
             "    finally:\n"
             "        gather_host_values(1)  # noqa: F821\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert findings == [], [f.render() for f in findings]


def test_marker_with_trailing_text_agrees_across_passes(tmp_path):
    """A marker with trailing text puts the file in scope: it is
    verified, and its stale protocol suppression flagged."""
    src = ("# tpudp: protocol-module (test fixture)\n"
           "import os\n\n\n"
           "def f(root):\n"
           "    if os.path.exists(root):\n"
           "        gather_host_values(1)  # noqa: F821\n"
           "    x = 1  # tpudp: lint-ok(protocol-early-exit): stale\n")
    pfind, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert sorted(f.rule for f in pfind) == [
        "protocol-divergent-entry", "useless-suppression"], \
        [f.render() for f in pfind]


def test_match_statement_arms_are_visible(tmp_path):
    src = (MARKER
           + "import os\n\n\n"
             "def f(root):\n"
             "    match os.path.exists(root):\n"
             "        case True:\n"
             "            gather_host_values(1)  # noqa: F821\n"
             "        case _:\n"
             "            pass\n")
    findings, _ = verify_paths(_paths(tmp_path, src), ROOT)
    assert [f.rule for f in findings] == ["protocol-divergent-entry"], \
        [f.render() for f in findings]


TORCH_SOURCES = {
    # a rank-0-only collective: its peers never join
    "rank-entry": ("import torch.distributed as dist\n\n\n"
                   "def f(t):\n"
                   "    if dist.get_rank() == 0:\n"
                   "        dist.barrier()\n",
                   ["protocol-divergent-entry"]),
    # an all-reduce decided by a per-rank listing
    "listing-entry": ("import os\n\nimport torch.distributed as dist\n\n\n"
                      "def f(root, t):\n"
                      "    if os.path.isdir(root):\n"
                      "        dist.all_reduce(t)\n",
                      ["protocol-divergent-entry"]),
    # the world size is the same on every rank: no finding
    "world-size": ("import torch.distributed as dist\n\n\n"
                   "def f(t):\n"
                   "    if dist.get_world_size() > 1:\n"
                   "        dist.all_gather_object([None], t)\n", []),
    # the port's wrapped collectives count as rendezvous too
    "staged": ("import time\n\nfrom tpudp_torch.parallel import "
               "collectives as C\n\n\n"
               "def f(t, g):\n"
               "    while time.time() < 5:\n"
               "        C.reduce_scatter(t, 0, g)\n",
               ["protocol-divergent-loop"]),
}


@pytest.mark.parametrize("case", sorted(TORCH_SOURCES))
def test_torch_distributed_rendezvous_are_verified(tmp_path, case):
    """torch.distributed's collectives (and the port's staged wrappers)
    are rendezvous; ``get_rank`` is a per-rank fact and
    ``get_world_size`` a rank-uniform one."""
    src, want = TORCH_SOURCES[case]
    findings, errors = verify_paths(_paths(tmp_path, MARKER + src), ROOT)
    assert not errors
    assert [f.rule for f in findings] == want, [f.render() for f in findings]


def test_protocol_modules_all_exist():
    """The port's scope: the counterpart of each of JAX's nine modules
    (JAX's ``train.py`` Trainer is the port's ``trainer.py``), each on
    disk."""
    counterparts = {m.replace("tpudp/", "tpudp_torch/", 1)
                    .replace("tpudp_torch/train.py", "tpudp_torch/trainer.py")
                    for m in JAX_PROTOCOL_MODULES}
    assert set(PROTOCOL_MODULES) == counterparts
    for rel in PROTOCOL_MODULES:
        assert os.path.exists(os.path.join(ROOT, rel)), rel


def test_port_multiprocess_modules_verify_clean():
    """Every module of the port in scope — the supervisor's SDC gather
    included — verifies clean; the suppressions it carries are JAX's, at
    the same sites, and each matches a finding."""
    findings, errors = verify_paths(["tpudp_torch"], ROOT)
    assert not errors, errors
    assert findings == [], [f.render() for f in findings]


# -- mutation tests -----------------------------------------------------


def _mutated_copy(tmp_path, old, new, name, source=RESILIENCE):
    src = open(os.path.join(ROOT, source)).read()
    assert old in src, "mutation target drifted — update the test"
    mutated = MARKER + src.replace(old, new)
    p = tmp_path / name
    p.write_text(mutated)
    return str(p), mutated


def _line_of(mutated: str, text: str) -> int:
    return next(i + 1 for i, line in enumerate(mutated.splitlines())
                if line.strip() == text)


def test_mutation_entry_probe_bug_is_named(tmp_path):
    """A per-rank listing probe deciding entry into the collective
    restore (``restore_newest``): named at the mutated line, with the
    reason chain down to ``os.listdir``."""
    new = "if latest_step_dir(checkpoint_dir) is not None:"
    path, mutated = _mutated_copy(
        tmp_path,
        "if coordinated_any(latest_step_dir(checkpoint_dir) is not None):",
        new, "resilience_probe.py")
    findings, errors = verify_paths([path, SEAM], ROOT)
    assert not errors, errors
    assert [(f.rule, f.line) for f in findings] == [
        ("protocol-early-exit", _line_of(mutated, new))], \
        [f.render() for f in findings]
    assert "latest_step_dir" in findings[0].message
    assert "os.listdir" in findings[0].message


def test_mutation_swapped_vote_order_is_named(tmp_path):
    old = ("cur_start, cur_skip = self._coordinated_recover(\n"
           "                            self._vote(code), e)")
    new = ("worst = self._coordinated_recover(code, e)\n"
           "                        cur_start, cur_skip = "
           "self._vote(worst), 0")
    path, mutated = _mutated_copy(tmp_path, old, new, "resilience_swap.py")
    findings, errors = verify_paths([path, SEAM], ROOT)
    assert not errors, errors
    assert [(f.rule, f.line) for f in findings] == [
        ("protocol-order-divergence",
         _line_of(mutated, "worst = self._coordinated_recover(code, e)"))], \
        [f.render() for f in findings]
    assert "_coordinated_recover" in findings[0].message
    assert "_vote" in findings[0].message


def test_unmutated_copy_is_clean(tmp_path):
    path, _ = _mutated_copy(tmp_path, "coordinated_any(",
                            "coordinated_any(", "resilience_ctl.py")
    findings, errors = verify_paths([path, SEAM], ROOT)
    assert not errors, errors
    assert findings == [], [f.render() for f in findings]


# -- the vote machine ---------------------------------------------------


def test_vote_machine_deadlock_free_within_bounds():
    src = open(os.path.join(ROOT, RESILIENCE)).read()
    for hosts in (2, 3):
        spec = extract_vote_spec(src, n_hosts=hosts, max_faults=2,
                                 max_crashes=1)
        assert spec.completion_park and spec.bounded_timeout
        result = explore_vote_machine(spec)
        assert result["violations"] == [], result["violations"][:3]
        assert result["states"] > 50


def test_vote_machine_catches_dropped_completion_park():
    src = open(os.path.join(ROOT, RESILIENCE)).read()
    target = "worst = self._vote(OUTCOME_OK)"
    assert target in src, "completion-vote spelling drifted — update test"
    spec = extract_vote_spec(src.replace(target, "worst = OUTCOME_OK"))
    assert spec.completion_park is False
    kinds = {v["kind"] for v in explore_vote_machine(spec)["violations"]}
    assert "spurious-timeout" in kinds
    frozen = VoteSpec(completion_park=False, bounded_timeout=False)
    kinds = {v["kind"]
             for v in explore_vote_machine(frozen)["violations"]}
    assert "deadlock" in kinds
    # and the bounded wait's hard exit, deleted from _vote, is seen too
    no_exit = src.replace("os._exit(VOTE_TIMEOUT_EXIT)", "pass")
    assert extract_vote_spec(no_exit).bounded_timeout is False


def test_vote_machine_crash_paths_resolve_via_timeout():
    ok = explore_vote_machine(VoteSpec(n_hosts=2, max_crashes=1))
    assert ok["violations"] == []
    bad = explore_vote_machine(VoteSpec(n_hosts=2, max_crashes=1,
                                        bounded_timeout=False))
    assert any(v["kind"] == "deadlock" for v in bad["violations"])


def test_protocol_cli_exit_codes(capsys):
    bad = os.path.join(FIXTURES, "bad_protocol_divergent_entry.py")
    good = os.path.join(FIXTURES, "good_protocol_divergent_entry.py")
    assert cli_main(["protocol", bad]) == 1
    assert "protocol-divergent-entry" in capsys.readouterr().out
    assert cli_main(["protocol", good]) == 0
    assert "deadlock-free within bounds" in capsys.readouterr().out
    assert cli_main(["protocol", "tpudp_torch/no_such_dir"]) == 2
    assert cli_main(["protocol"]) == 0  # the port's modules, clean


def test_verify_paths_is_torch_and_jax_free():
    """Loaded by file path, the verifier runs over the port without
    importing torch or jax."""
    code = (
        "import importlib.util, sys, os\n"
        f"pkg = {os.path.join(ROOT, 'tpudp_torch', 'analysis')!r}\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    '_a', os.path.join(pkg, '__init__.py'),\n"
        "    submodule_search_locations=[pkg])\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['_a'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "from _a.protocol import verify_paths\n"
        f"f, e = verify_paths(['tpudp_torch'], {ROOT!r})\n"
        "assert 'jax' not in sys.modules, 'imported jax'\n"
        "assert 'torch' not in sys.modules, 'imported torch'\n"
        "print(len(f), len(e))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "0"]


# -- the migration handshake (tests/test_disagg.py's verifier tests) -----


def test_disagg_is_a_protocol_module_and_verifies_clean():
    assert DISAGG.replace(os.sep, "/") in PROTOCOL_MODULES
    findings, errors = verify_paths([DISAGG, SEAM], ROOT)
    assert not errors, errors
    assert findings == [], [f.render() for f in findings]


def test_mutation_quarantine_early_exit_fails_by_rule_name(tmp_path):
    """An early exit in ``DisaggHost.round``'s quarantine arm strands the
    sender at the ack gather: protocol-early-exit at the mutated line;
    the unmutated copy is clean."""
    src = open(os.path.join(ROOT, DISAGG)).read()
    old = "self._quarantine(src, b, exc)"
    assert old in src, "quarantine spelling drifted — update the test"
    mutated = MARKER + src.replace(old, "return False", 1)
    p = tmp_path / "disagg_mutant.py"
    p.write_text(mutated)
    findings, errors = verify_paths([str(p), SEAM], ROOT)
    assert not errors, errors
    hits = [f for f in findings if f.rule == "protocol-early-exit"]
    assert any(f.line == _line_of(mutated, "return False") for f in hits), \
        [(f.rule, f.line) for f in findings]
    q = tmp_path / "disagg_ctl.py"
    q.write_text(MARKER + src)
    findings2, errors2 = verify_paths([str(q), SEAM], ROOT)
    assert not errors2 and findings2 == [], \
        [f.render() for f in findings2]


def test_migration_model_checker_live_source_clean():
    src = open(os.path.join(ROOT, DISAGG)).read()
    spec = extract_migration_spec(src)
    assert spec.quarantine_acks and spec.release_on_ack
    assert spec.fallback_local
    result = explore_migration_machine(spec)
    assert result["violations"] == [], result["violations"][:3]
    assert result["states"] > 5


def test_migration_model_checker_catches_each_deletion():
    """Deleting each property names its violation: the quarantine arm
    raising (from the mutated source) an orphaned rendezvous, release
    before the ack gather a page leak, no local fallback a wedge."""
    src = open(os.path.join(ROOT, DISAGG)).read()
    mutated = src.replace("self._quarantine(src, b, exc)", "raise", 1)
    spec = extract_migration_spec(mutated)
    assert spec.quarantine_acks is False
    kinds = {v["kind"]
             for v in explore_migration_machine(spec)["violations"]}
    assert "orphaned-rendezvous" in kinds
    base = extract_migration_spec(src)
    for flip, want in (("release_on_ack", "page-leak"),
                       ("fallback_local", "wedge")):
        bad = MigrationSpec(**{**base.__dict__, flip: False})
        kinds = {v["kind"]
                 for v in explore_migration_machine(bad)["violations"]}
        assert want in kinds, (flip, kinds)
    no_fb = src.replace("r = self.engine.admit_ticket(p.ticket)",
                        "r = None", 1)
    assert extract_migration_spec(no_fb).fallback_local is False
