"""Experiments: the scenario registry, runner, campaign engine and
report layer of the port.

  python -m repro_torch.experiments list
  python -m repro_torch.experiments run --scenario rram_accuracy
  python -m repro_torch.experiments run --all
  python -m repro_torch.experiments report
"""
from .scenarios import (Budget, DEFAULT_BUDGET, REGISTRY, SMOKE_BUDGET,
                        Scenario, get_scenario, scenario_names)
from .runner import (DEFAULT_OUT_DIR, RESULT_SCHEMA_VERSION,
                     build_scenario_scorer, cache_key_fields,
                     finalize_result, load_cached_result, run_alg_compare,
                     run_mo_search_batched, run_scenario,
                     run_search_batched, run_specific_fanout,
                     run_specific_sequential, setup_scenario,
                     specific_edap)
from .campaign import (enable_persistent_cache, plan_campaign,
                       run_campaign)
from .report import (aggregate_seeds, compute_gap, load_campaign_stats,
                     load_results, render_campaign_stats, render_markdown,
                     render_summary, write_artifacts, write_summary)
