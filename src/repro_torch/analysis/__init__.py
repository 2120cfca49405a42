"""The port's analysis suite: repo-specific AST lint (R001-R004, pure
stdlib) over ``src/repro_torch`` + the launch audit (J000-J003, runs
every scenario's search calls under torch); counterpart of
``repro/analysis``. CLI: ``python -m repro_torch.analysis --all``.
Suppressions live in ``analysis/torch_suppressions.txt``, the launch
baseline in ``analysis/torch_baseline.json``."""
from .findings import (Finding, Suppression, SUPPRESSION_FILE,
                       apply_suppressions, load_suppressions,
                       parse_suppressions)
from .ast_rules import (ALLOWED_INTERNAL, FACADE_ONLY, FACADE_SCAN_DIRS,
                        check_cache_key, check_deprecated, check_facade,
                        check_facade_source, check_traced_purity,
                        run_ast_rules)

__all__ = [
    "ALLOWED_INTERNAL", "FACADE_ONLY", "FACADE_SCAN_DIRS", "Finding",
    "SUPPRESSION_FILE", "Suppression", "apply_suppressions",
    "check_cache_key", "check_deprecated", "check_facade",
    "check_facade_source", "check_traced_purity", "load_suppressions",
    "parse_suppressions", "run_ast_rules",
]
