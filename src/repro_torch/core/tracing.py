"""Search-region markers: the ``@traced_closure`` decorator + registry;
counterpart of ``repro/core/tracing.py``.

Every function that runs INSIDE a search call — scorer closures
(``core.scoring.build_scorer``), the GA / NSGA-II / baseline generation
steps, the device sampler, the workload builder — should queue device
work and nothing else: no host syncs (``.item()``, ``float()``/
``int()``/``bool()`` on tensors, ``.cpu()``, ``.numpy()``,
``.tolist()``, ``torch.cuda.synchronize()``), no per-call ``np.*`` work,
no wall-clock or Python RNG, no printing, no global mutation. Each host
sync stalls the eager launch queue and stops a CUDA graph of the step.
``@traced_closure`` marks such a function so the analysis suite
(``python -m repro_torch.analysis``, rule R001) audits its body; at
run time it is a zero-cost annotation — the function is returned
unchanged.

The registry is keyed by (module, qualname), so closures rebuilt per
``build_scorer`` call overwrite their slot instead of accumulating:
at most one instance per marked site is ever pinned.

This module is import-free on purpose (no torch, no numpy): it sits
below everything in core/ and must never create an import cycle.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

#: (module, qualname) -> the most recently constructed marked closure.
TRACED_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def traced_closure(fn: Callable) -> Callable:
    """Mark ``fn`` as a search-region function (see module docstring).

    Purely declarative: sets ``__traced_closure__`` and records the
    function in :data:`TRACED_REGISTRY`, then returns ``fn`` unchanged
    (no wrapper, no call overhead).
    """
    fn.__traced_closure__ = True
    TRACED_REGISTRY[(fn.__module__, fn.__qualname__)] = fn
    return fn


def traced_sites() -> Tuple[Tuple[str, str], ...]:
    """Sorted (module, qualname) keys of every registered marked site."""
    return tuple(sorted(TRACED_REGISTRY))
