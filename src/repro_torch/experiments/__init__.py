"""Experiments: the scenario registry, runner and report layer of the
port.

  python -m repro_torch.experiments list
  python -m repro_torch.experiments run --scenario rram_accuracy
  python -m repro_torch.experiments report
"""
from .scenarios import (Budget, DEFAULT_BUDGET, REGISTRY, SMOKE_BUDGET,
                        Scenario, get_scenario)
from .runner import (DEFAULT_OUT_DIR, RESULT_SCHEMA_VERSION,
                     build_scenario_scorer, cache_key_fields,
                     finalize_result, load_cached_result, run_scenario,
                     run_search_batched, run_specific_fanout, setup_scenario,
                     specific_edap)
from .report import (aggregate_seeds, compute_gap, render_markdown,
                     render_summary, write_artifacts, write_summary)
