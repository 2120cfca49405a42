"""Declarative scenario registry for the paper's design points;
counterpart of ``repro/experiments/scenarios.py``.

The whole ``REGISTRY`` is copied, so scenario names, budgets and cache
keys line up with the reference's. Each Scenario names one cell of the
paper's evaluation grid — {RRAM, SRAM} x {single-workload,
small-set/4, large-set/9} x {optimized 4-phase GA, plain GA,
random-search baseline} — plus the Table 3 algorithm comparison and
the beyond-paper scenarios.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..core.search_space import (SearchSpace, get_space, joint_space,
                                 reduced_rram_space)
from ..core.workloads import (FAMILY_NAMES, PAPER_4, PAPER_9,
                              WorkloadFamily, from_arch_config, get_family,
                              get_workload, get_workload_set)

# Largest paper workload: the single-workload (specialized) design point
# the cross-workload comparisons normalize against (paper Fig. 3).
LARGEST_WORKLOAD = "vgg16"

# The assigned LM architectures exported as IMC workloads (the
# beyond-paper scenario of examples/codesign_lm_archs.py; the port's
# counterpart is repro_torch/examples/codesign_lm_archs.py).
LM_ARCHS = ("qwen3_4b", "qwen2_5_3b", "xlstm_350m", "hubert_xlarge",
            "phi4_mini_3_8b")

# "alg_compare" is the §III-C1 / Table 3 study: it runs ALL of
# GA/PSO/ES/SRES/CMA-ES/G3PCX (the device-resident baseline engine,
# core/baselines.py) over the scenario's seeds and reports per-
# algorithm global-min hit rates instead of a single search result.
ALGORITHMS = ("fourphase", "plain", "random", "alg_compare")


@dataclasses.dataclass(frozen=True)
class Budget:
    """Search budget knobs (paper Algorithm 1 symbols).

    p_h/p_e/p_ga: Hamming-sampling pool / diverse subset / GA population.
    generations: per phase (4-phase GA runs 4x this; plain GA and random
    search get the equal total budget — see runner.py).
    n_seeds: independent search repetitions, executed as ONE batched
    device computation (vmap over the seed axis); results report
    mean±std EDAP/gap — the paper's robustness claim a single seed
    cannot support. Override per run with ``--seeds`` on the CLI.
    """
    p_h: int = 300
    p_e: int = 120
    p_ga: int = 24
    generations: int = 4
    n_seeds: int = 1

    @property
    def total_generations(self) -> int:
        return 4 * self.generations

    @property
    def n_evaluations(self) -> int:
        """Evaluation budget of the 4-phase search at this scale — the
        budget-fair allowance for the random-search baseline."""
        return self.p_h + self.p_ga * self.total_generations


# Reduced relative to the paper's 64-core scale (P_H=1000/P_E=500/G=10),
# matching benchmarks/common.py; qualitative claims are scale-robust.
DEFAULT_BUDGET = Budget()
# Tiny budget for CPU smoke runs and CI.
SMOKE_BUDGET = Budget(p_h=40, p_e=16, p_ga=8, generations=1)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named, fully-resolved experiment design point."""
    name: str
    mem: str                       # "rram" | "sram"
    workloads: Tuple[str, ...]     # paper workload names OR arch ids
    algorithm: str                 # one of ALGORITHMS
    objective: str = "edap:mean"   # core.objectives.make_objective spec
    budget: Budget = DEFAULT_BUDGET
    seed: int = 0
    seq: int = 256                 # sequence length for arch workloads
    tech_variable: bool = False
    workload_source: str = "paper"  # "paper" | "archs" | "family"
    specific_baselines: bool = True  # per-workload specific searches
    # §III-C1: search the exhaustively-enumerable reduced RRAM space
    # (Xbar_rows, Xbar_cols, C_per_tile, Bits_cell) instead of the full
    # hierarchy — the Table 3 algorithm-comparison setting.
    reduced_space: bool = False
    # Budget substituted by the CLI's ``run --smoke``. Scenario-
    # specific because the Table 3 study needs its seed count (hit
    # rates over >= 5 seeds) and a few more iterations even at smoke
    # scale, where a single-search scenario does not.
    smoke_budget: Budget = SMOKE_BUDGET
    # Calibration fidelity of the non-ideality accuracy model (§IV-H):
    # number of calibration GEMM rows and reduction depth fed through
    # the noisy crossbar. A registry decision (fidelity vs search
    # speed), threaded into core.nonideal.make_accuracy_model and part
    # of the runner's result-cache key. Only consumed by edap_acc
    # objectives.
    n_calib: int = 32
    calib_k: int = 256
    # Hard per-workload accuracy floor (joint co-search counterweight):
    # designs whose non-ideality-degraded accuracy on any workload
    # falls below this bar are penalized infeasible. 0.0 = off.
    min_accuracy: float = 0.0
    # Accuracy-model crossbar-GEMM route (core.nonideal.BACKENDS):
    # 'auto' resolves per device ('cuda', the fused Hopper kernel, on a
    # GPU; 'jnp' on the CPU); 'cuda' / 'ref' / 'jnp' force a route. All
    # routes agree to float tolerance (tests/test_torch_core.py); the
    # resolved choice is part of the runner's result-cache key.
    # Override per run with ``--backend`` on the CLI.
    backend: str = "auto"
    paper_ref: str = ""
    description: str = ""

    def space(self) -> SearchSpace:
        if self.reduced_space:
            if self.mem != "rram":
                raise ValueError("the §III-C1 reduced space is RRAM")
            base = reduced_rram_space()
        else:
            base = get_space(self.mem, self.tech_variable)
        if self.workload_source == "family":
            families = [w for w in self.resolve_workloads()
                        if isinstance(w, WorkloadFamily)]
            return joint_space(base, families)
        return base

    def resolve_workloads(self) -> List:
        if self.workload_source == "archs":
            from ..configs import get_config  # the LM stack, on demand
            return [from_arch_config(get_config(a), seq=self.seq)
                    for a in self.workloads]
        if self.workload_source == "family":
            # family names resolve to WorkloadFamily; fixed workload
            # names may be mixed in (constant slots of the joint space)
            return [get_family(n) if n in FAMILY_NAMES else get_workload(n)
                    for n in self.workloads]
        return get_workload_set(self.workloads)


def _build_registry() -> Dict[str, Scenario]:
    reg: Dict[str, Scenario] = {}

    def add(s: Scenario) -> None:
        assert s.name not in reg, f"duplicate scenario {s.name!r}"
        reg[s.name] = s

    alg_label = {"fourphase": "optimized 4-phase GA",
                 "plain": "plain (non-modified) GA",
                 "random": "random-search baseline"}
    set_specs = {
        "single": ((LARGEST_WORKLOAD,),
                   "single workload (largest: VGG16)", "Fig. 3"),
        "small_set": (PAPER_4, "small set (4 workloads)", "Table 1"),
        "large_set": (PAPER_9, "large set (9 workloads)", "Table 2"),
    }
    for mem in ("rram", "sram"):
        for set_name, (wls, set_label, ref) in set_specs.items():
            for alg in alg_label:
                name = f"{mem}_{set_name}"
                if alg != "fourphase":
                    name += f"_{alg}"
                add(Scenario(
                    name=name, mem=mem, workloads=tuple(wls),
                    algorithm=alg,
                    # single-workload: no cross-workload gap to measure
                    specific_baselines=(set_name != "single"),
                    paper_ref=ref,
                    description=(f"{mem.upper()} IMC, {set_label}, "
                                 f"{alg_label[alg]}"),
                ))
        # tiny CPU smoke scenario per memory (CI / quickstart)
        add(Scenario(
            name=f"{mem}_smoke", mem=mem,
            workloads=("resnet18", "alexnet"),
            algorithm="fourphase", budget=SMOKE_BUDGET,
            paper_ref="(smoke)",
            description=(f"{mem.upper()} tiny 2-workload smoke run "
                         "(seconds on CPU)"),
        ))
    # beyond-paper: generalized SRAM design for the assigned LM archs
    add(Scenario(
        name="sram_lm_archs", mem="sram", workloads=LM_ARCHS,
        algorithm="fourphase", workload_source="archs", seq=256,
        paper_ref="(beyond paper)",
        description=("SRAM IMC co-optimized for the assigned LM "
                     "architecture set (examples/codesign_lm_archs.py)"),
    ))
    # §IV-H (Eq. 4): accuracy-aware RRAM co-design — EDAP / prod(Acc_w)
    # with the batched non-ideality model (core/nonideal.py) scoring
    # the BASELINE_ACC workloads inside the compiled search.
    add(Scenario(
        name="rram_accuracy", mem="rram", workloads=PAPER_4,
        algorithm="fourphase", objective="edap_acc:mean",
        paper_ref="§IV-H (Eq. 4)",
        description=("RRAM IMC, small set (4 workloads), accuracy-aware "
                     "objective: EDAP divided by the product of "
                     "non-ideality-degraded accuracies (device-resident "
                     "noisy-crossbar model)"),
    ))
    # §IV-I (Fig. 9 / Table 7): technology as a search variable, cost-
    # aware objective — EDAP with alpha(tech) * area replacing raw area;
    # the runner attaches the EDAP × cost Pareto front to the result.
    for mem in ("rram", "sram"):
        add(Scenario(
            name=f"{mem}_tech_cost", mem=mem, workloads=PAPER_4,
            algorithm="fourphase", objective="edap_cost:mean",
            tech_variable=True, paper_ref="Fig. 9 / Table 7",
            description=(f"{mem.upper()} IMC, small set (4 workloads), "
                         "technology node in the genome, fabrication-"
                         "cost-aware objective + EDAP×cost Pareto "
                         "front"),
        ))
    # Table 3 / §III-C1: the algorithm-selection study behind the GA
    # choice — GA vs PSO/(µ+λ)-ES/SRES/CMA-ES/G3PCX, every algorithm a
    # device-resident scan kernel (core/baselines.py), all seeds of
    # each algorithm one batched device call. The reduced-space
    # scenario enumerates its 240 designs exhaustively for the
    # ground-truth global minimum; hit rates are reported per
    # algorithm. The full-space variant keeps the real constrained
    # objective (SRES's stochastic ranking gets a graded
    # infeasibility penalty channel) and measures hits against the
    # best design any algorithm found.
    add(Scenario(
        name="table3_reduced_rram", mem="rram", workloads=PAPER_4,
        algorithm="alg_compare", objective="edap:mean",
        reduced_space=True, specific_baselines=False,
        budget=Budget(p_h=300, p_e=120, p_ga=24, generations=10,
                      n_seeds=5),
        smoke_budget=Budget(p_h=40, p_e=16, p_ga=8, generations=3,
                            n_seeds=5),
        paper_ref="Table 3 / §III-C1",
        description=("Algorithm-selection study on the reduced RRAM "
                     "space (240 designs, exhaustive ground truth): "
                     "GA vs PSO/ES/SRES/CMA-ES/G3PCX global-min hit "
                     "rates, every optimizer a scan-compiled device "
                     "kernel"),
    ))
    add(Scenario(
        name="alg_compare_rram", mem="rram", workloads=PAPER_4,
        algorithm="alg_compare", objective="edap:mean",
        specific_baselines=False,
        budget=Budget(p_h=300, p_e=120, p_ga=24, generations=10,
                      n_seeds=5),
        smoke_budget=Budget(p_h=40, p_e=16, p_ga=8, generations=3,
                            n_seeds=5),
        paper_ref="§III-C1 (full space)",
        description=("Beyond-paper: the same six-algorithm comparison "
                     "on the FULL RRAM space under the real "
                     "constrained objective (capacity/area penalties; "
                     "SRES ranks with a graded infeasibility penalty "
                     "channel); hits vs the best design found"),
    ))
    # §IV-I by *direct* multi-objective search: the EDAP × cost front
    # searched with the device-resident NSGA-II engine (core/nsga.py)
    # instead of filtered post hoc from a scalarized GA's visited
    # designs. The '+'-joined objective spec makes the runner dispatch
    # to the NSGA-II kernel; the report compares the searched front
    # against the post-hoc one (hypervolume + coverage).
    for mem in ("rram", "sram"):
        add(Scenario(
            name=f"{mem}_tech_cost_mo", mem=mem, workloads=PAPER_4,
            algorithm="fourphase", objective="edap:mean+cost",
            tech_variable=True, specific_baselines=False,
            paper_ref="Fig. 9 / Table 7",
            description=(f"{mem.upper()} IMC, small set (4 workloads), "
                         "technology node in the genome, EDAP × "
                         "fabrication-cost front searched directly "
                         "with device-resident NSGA-II"),
        ))
    # Joint workload-architecture × hardware co-search (ROADMAP's
    # "biggest scenario unlock", cf. CIMNAS/NAX): the genome carries
    # trailing architecture dimensions (depth, width, heads/FF ratio,
    # per-layer weight bits); a traced workload builder turns the arch
    # slice into padded layer tensors inside the same compiled scan.
    # The min_accuracy bar (scored by the noise-coupled accuracy model)
    # is what keeps the search from collapsing to the smallest/lowest-
    # precision architecture.
    add(Scenario(
        name="joint_rram_resnet_family", mem="rram",
        workloads=("resnet_family",), algorithm="fourphase",
        objective="edap:mean", workload_source="family",
        specific_baselines=False, min_accuracy=0.60,
        paper_ref="(beyond paper: joint co-search)",
        description=("Joint RRAM hardware × ResNet-architecture "
                     "co-search (depth/width/per-layer weight bits in "
                     "the genome) under a 60% accuracy floor"),
    ))
    add(Scenario(
        name="joint_rram_vit_family", mem="rram",
        workloads=("vit_family",), algorithm="fourphase",
        objective="edap:mean", workload_source="family",
        specific_baselines=False, min_accuracy=0.58,
        paper_ref="(beyond paper: joint co-search)",
        description=("Joint RRAM hardware × ViT-architecture co-search "
                     "(depth/heads/FF ratio/weight bits in the genome) "
                     "under a 58% accuracy floor"),
    ))
    add(Scenario(
        name="joint_rram_mo", mem="rram",
        workloads=("resnet_family",), algorithm="fourphase",
        objective="edap:mean+acc_loss:mean", workload_source="family",
        specific_baselines=False,
        paper_ref="(beyond paper: joint co-search)",
        description=("Joint RRAM × ResNet-architecture multi-objective "
                     "co-search: EDAP × accuracy-loss front via "
                     "device-resident NSGA-II, architecture choice "
                     "read off each front design"),
    ))
    return reg


REGISTRY: Dict[str, Scenario] = _build_registry()


def scenario_names() -> List[str]:
    return list(REGISTRY)


def get_scenario(name: str) -> Scenario:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(REGISTRY)
        raise KeyError(f"unknown scenario {name!r}; known: {known}") \
            from None


def paper_table_scenarios() -> Dict[str, List[str]]:
    """paper_ref -> scenario names, for the README reproduce-tables
    section and the cross-scenario summary report."""
    out: Dict[str, List[str]] = {}
    for s in REGISTRY.values():
        out.setdefault(s.paper_ref, []).append(s.name)
    return out
