"""tpudp_torch.analysis — the port's static and dynamic analysis: the
counterpart of ``tpudp/analysis/``.

``python -m tpudp_torch.analysis lint [paths]`` runs the hazard rules
(:mod:`.rules`) over the port; ``protocol [paths]`` verifies that every
path through the multi-process modules (:data:`PROTOCOL_MODULES`)
makes the same ordered rendezvous on every rank unless a rank-uniform
predicate guards the difference, then explores the vote machine
extracted from ``tpudp_torch/resilience.py``; ``audit`` runs the
registered step programs (:mod:`.programs`) and diffs their census and
budget ledgers against ``program_lock.json``; ``check`` runs all three.
Exit 0 clean, 1 on a finding, 2 on a bad path or an unreadable lock.
:func:`extract_migration_spec` and :func:`explore_migration_machine`
check the migration handshake of ``tpudp_torch/serve/disagg.py``.

The lint, the protocol verifier and the package import are stdlib only
(torch loads inside the audit's capture), so they run without torch or
jax.
"""

from .core import (PROTOCOL_MODULES, PROTOCOL_RULE_NAMES,  # noqa: F401
                   Finding, Module, lint_paths)
from .protocol import (MigrationSpec, VoteSpec,  # noqa: F401
                       explore_migration_machine, explore_vote_machine,
                       extract_migration_spec, extract_vote_spec)
from .protocol import verify_paths as verify_protocol  # noqa: F401
from .rules import RULES, RULES_BY_NAME  # noqa: F401
