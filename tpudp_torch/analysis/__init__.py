"""tpudp_torch.analysis — the cross-rank protocol verifier and the model
checkers, the framework-neutral half of ``tpudp/analysis/``.

``python -m tpudp_torch.analysis protocol [paths]`` verifies that every
path through the port's multi-process modules (:data:`PROTOCOL_MODULES`)
issues the same ordered sequence of rendezvous on every rank unless a
rank-uniform predicate guards the difference, then explores the vote
machine extracted from ``tpudp_torch/resilience.py``; exit 0 clean, 1 on
a finding, 2 on a bad path.  :func:`extract_migration_spec` and
:func:`explore_migration_machine` check the migration handshake of
``tpudp_torch/serve/disagg.py``.

Stdlib only: the package imports neither torch nor jax, so it loads and
runs without either.  The JAX package's lint rules and its jaxpr audit
(``rules.py``, ``audit.py``, ``budget.py``, ``programs.py``) are not
ported (ROADMAP.md, Queue 1).
"""

from .core import (PROTOCOL_MODULES, PROTOCOL_RULE_NAMES,  # noqa: F401
                   Finding, Module)
from .protocol import (MigrationSpec, VoteSpec,  # noqa: F401
                       explore_migration_machine, explore_vote_machine,
                       extract_migration_spec, extract_vote_spec)
from .protocol import verify_paths as verify_protocol  # noqa: F401
