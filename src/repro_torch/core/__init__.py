"""Core of the port: search space, cost model, objectives, accuracy
model, scorer, Hamming sampling and the four-phase GA."""
from .search_space import SearchSpace, get_space, rram_space, sram_space
from .workloads import (PAPER_4, PAPER_9, Workload, WorkloadArrays,
                        from_arch_config, get_workload, get_workload_set,
                        pack)
from .cost_model import (CostMetrics, HWConstants, evaluate_population,
                         make_evaluator)
from .objectives import (INFEASIBLE_PENALTY, Objective, aggregate_scores,
                         make_objective, per_workload_scores)
from .nonideal import BACKENDS, BASELINE_ACC, CALIB_SEED, make_accuracy_model
from .scoring import Calib, Scorer, ScorerSpec, build_scorer
from .sampling import hamming_select, sample_initial_device, uniform_genomes
from .genetic import (FOUR_PHASES, PLAIN_PHASE, MultiSearchResult, Phase,
                      SearchResult, batched_joint_search, ga_scan,
                      phase_schedule, plain_ga_search, random_search,
                      search_kernel)
