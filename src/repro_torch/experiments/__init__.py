"""Experiments: the scenario registry, runner, campaign engine and
report layer of the port.

  python -m repro_torch.experiments list
  python -m repro_torch.experiments run --scenario rram_accuracy
  python -m repro_torch.experiments run --all
  python -m repro_torch.experiments report
"""
from .scenarios import (Budget, DEFAULT_BUDGET, REGISTRY, SMOKE_BUDGET,
                        Scenario, get_scenario, paper_table_scenarios,
                        scenario_names)
from .runner import (DEFAULT_OUT_DIR, RESULT_SCHEMA_VERSION,
                     build_scenario_scorer, cache_key_fields,
                     enumerate_ground_truth, finalize_result,
                     load_cached_result, make_infeasibility_penalty,
                     make_landscape_scorer, make_scorer,
                     make_traced_scorer, run_alg_compare,
                     run_mo_search_batched, run_scenario, run_search,
                     run_search_batched, run_specific_fanout,
                     run_specific_sequential, setup_scenario,
                     specific_edap)
from .campaign import (enable_persistent_cache, plan_campaign,
                       run_campaign)
from .report import (aggregate_seeds, baseline_reductions, compute_gap,
                     load_campaign_stats, load_results,
                     render_campaign_stats, render_convergence,
                     render_front_comparison, render_markdown,
                     render_summary, render_table3,
                     render_table3_markdown, write_artifacts,
                     write_summary)
