"""Core of the port: search space, cost model, objectives, accuracy
model, scorer, Hamming sampling, the four-phase GA, NSGA-II, the Table 3
baseline optimizers and the Pareto-front tools, with the joint
workload-architecture co-search, and lane batching across devices
(``distributed``)."""
from .search_space import (SearchSpace, get_space, joint_space,
                           reduced_rram_space, rram_space, sram_space)
from .workloads import (FAMILY_NAMES, PAPER_4, PAPER_9, ArchParam, Workload,
                        WorkloadArrays, WorkloadBuilder, WorkloadFamily,
                        WorkloadTensors, from_arch_config, get_family,
                        get_workload, get_workload_set,
                        make_workload_builder, pack, resnet_family,
                        vit_family)
from .cost_model import (CostMetrics, HWConstants, evaluate_population,
                         evaluate_population_joint, make_evaluator,
                         make_joint_evaluator)
from .objectives import (AREA_CONSTRAINT_MM2, INFEASIBLE_PENALTY,
                         MultiObjective, Objective, aggregate_scores,
                         is_multi_spec, make_multi_objective,
                         make_objective, per_workload_scores)
from .nonideal import (BACKENDS, BASELINE_ACC, CALIB_SEED,
                       accuracy_proxy_host, make_accuracy_model,
                       noisy_crossbar_gemm, resolve_backend)
from .scoring import Calib, Scorer, ScorerSpec, build_scorer, sharded_score_fn
from .sampling import (hamming_select, random_genomes, sample_initial,
                       sample_initial_device, uniform_genomes)
from .genetic import (FOUR_PHASES, PLAIN_PHASE, MultiSearchResult, Phase,
                      SearchResult, batched_joint_search, ga_scan,
                      joint_search, phase_schedule, plain_ga_search,
                      random_search, run_ga, run_ga_loop, search_kernel)
from .pareto import (edap_cost_front, front_coverage, hypervolume_2d,
                     pareto_front)
from .nsga import (MOSearchResult, MultiMOSearchResult, batched_nsga_search,
                   crowding_distance, dominance_matrix,
                   dominance_matrix_tiled, nondominated_rank, nsga_scan,
                   nsga_search, nsga_search_kernel, run_nsga_loop)
from .baselines import (BASELINE_ALGORITHMS, BaselineResult,
                        MultiBaselineResult, baseline_kernel,
                        baseline_scan, baseline_search,
                        batched_baseline_search, cmaes_search, es_search,
                        g3pcx_search, pso_search, run_baseline_loop,
                        stochastic_rank)
from .tracing import TRACED_REGISTRY, traced_closure, traced_sites
from . import baselines, distributed, nonideal, nsga, pareto, scoring
