"""Multi-pod dry run: trace every (arch x shape x mesh) cell once over a
fake process group; counterpart of ``repro/launch/dryrun.py``, with its
flags and its record.

A planning tool: it runs in one host process, needs no card, and
allocates nothing. ``init_process_group("fake")`` over a ``FakeStore``
stands for the 256 or 512 ranks of the production mesh
(``make_production_mesh`` binds a CPU ``DeviceMesh`` over them), as the
reference's 512 placeholder host devices do; this process is rank 0.
Parameters come from ``models.param_specs``' init under
``FakeTensorMode``, ``m`` and ``v`` are placed by ``zero1_specs``, the
batch by ``batch_partition_spec`` and the cache by ``cache_specs``: fake
DTensors over fake CPU tensors, so the kernels' plain versions are what
is traced (a kernel is a ctypes call and takes no fake tensor). The
cell's step runs once:

- train: ``train.loop``'s step over the mesh (``--accum``,
  ``--no-remat``, ``--seq-parallel``: the reference's ``seq_spec``);
- prefill: ``models.prefill``, or the encoder's forward;
- decode: ``models.decode_step`` (``--kv-quant``).

Every cell runs on this rank's shards with its compute split over
"model" (``models/split.py``, as the port's train step and the
reference's GSPMD split it), the batch and the cache this data rank's
part; the cache is placed batch-only (replicated over "model"), so
prefill and decode write it whole on every rank. The record has the
reference's keys; what they hold here:

- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over this
  rank's work (per device, as XLA's cost analysis is): the products on
  this rank's shards, and the plain flash's whole S x T scores of its
  heads;
- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
  are the local shards' bytes of the step's inputs and outputs;
  ``temp_size_in_bytes`` is the peak of the bytes allocated during the
  step and alive at once (outputs made in the step included), by a
  dispatch mode that follows every fake tensor's storage;
- ``collective_bytes``: the five reference names, each the result bytes
  of this rank's collectives of that kind (the reference's
  ``_line_result_bytes`` convention): ``parallel.tensor_parallel``'s
  under their own names (a rank-ordered reduce-scatter's part, an
  all-reduce's whole, made of ``all_to_all_single`` and all-gathers),
  other functional collectives as they are;
- ``lower_s``: building the placed state; ``compile_s``: the traced
  step (nothing compiles);
- ``model_flops``: the reference's formulas (``model_flops``).

``--cache-sharding`` is taken for the reference's command lines, but
both its values place the cache by ``cache_specs`` (the reference's
``batch``): the port has no partitioner to choose a layout for
``auto``, and says so when a decode cell runs with it. The ``imc_search`` cell is one
rank's scorer on its 8192 / n rows, ``model_flops`` 0.

Usage:
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --arch mixtral_8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --arch imc_search
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterable, List, Tuple, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, cell_runnable, get_config
from ..models import ArchConfig
from ..models.transformer import (LM, decode_step, forward, init_cache,
                                  prefill)
from ..parallel.sharding import (P, batch_axes, batch_partition_spec,
                                 cache_specs, is_placed)
from ..parallel.tensor_parallel import (inside_collective, local_params,
                                        record_collectives, split_of,
                                        use_split)
from ..train.loop import (TrainState, elastic_remesh, init_train_state,
                          make_train_step, train_state_shardings)
from ..train.optimizer import AdamWState
from .mesh import Mesh, make_production_mesh, mesh_context

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives (``torch.distributed._functional_collectives``
# dispatches them as ``_c10d_functional`` ops) by the reference's names
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def _collective_of(func) -> str:
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return ""
    return _KINDS.get(func._opname, "")


def collective_bytes(events: Iterable[Tuple[str, float]]
                     ) -> Dict[str, float]:
    """Result bytes by the reference's collective names, from the
    ``(collective, result bytes)`` events a ``StepTrace`` records."""
    out = {c: 0.0 for c in COLLECTIVES}
    for kind, nbytes in events:
        out[kind] += float(nbytes)
    return out


class StepTrace(TorchDispatchMode):
    """Records, for every op dispatched inside it: the result bytes of each
    functional collective (``events``), and the bytes of the storages
    made inside it and alive at once (``live``, ``peak``), each storage
    counted from its first tensor until its last is freed. Storages of
    ``known`` tensors (the step's arguments) are not counted."""

    def __init__(self, known: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.events: List[Tuple[str, float]] = []
        self.live = self.peak = 0
        self._known = {_storage_key(t) for t in known}
        self._storages: Dict[int, list] = {}
        self._tensors: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a collective of ``parallel.tensor_parallel`` is recorded under
        # its own name (``record_collectives``), not as the raw ones it
        # is made of
        kind = "" if inside_collective() else _collective_of(func)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not is_placed(t):
                if kind:
                    self.events.append((kind, t.numel() * t.element_size()))
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if id(t) in self._tensors or key in self._known:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._tensors.add(id(t))
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        self._tensors.discard(tid)
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _locals(tree: Any) -> List[torch.Tensor]:
    """Every tensor of ``tree`` as this rank holds it (a DTensor's local
    tensor; a model's parameters)."""
    out = []
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out += _locals(list(x.parameters()))
        elif isinstance(x, torch.Tensor):
            out.append(x.to_local() if is_placed(x) else x)
    return out


def _nbytes(tree: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _locals(tree)))


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """The reference's useful-work count of a cell: 6 N T to train, 2 N T
    to prefill, 2 N B a decode step (N the active parameters)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _shape(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _local_batch(cfg: ArchConfig, mesh: Mesh, B: int, S: int):
    """This data rank's part of a batch of ``B`` rows: fake tensors, the
    rows that ``batch_partition_spec`` gives the rank (all of them when
    the batch axes do not divide ``B``)."""
    n = B
    if batch_partition_spec(mesh, B)[0] is not None:
        for a in batch_axes(mesh):
            n //= mesh.shape[a]
    batch = {}
    if cfg.frontend == "audio":
        batch["frames"] = torch.zeros((n, S, cfg.frontend_dim),
                                      dtype=cfg.torch_dtype)
    else:
        batch["tokens"] = torch.zeros((n, S), dtype=torch.int32)
    batch["labels"] = torch.zeros((n, S), dtype=torch.int32)
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.zeros(
            (n, cfg.n_img_tokens, cfg.d_vision), dtype=cfg.torch_dtype)
    return batch, n


def _batch_only(x: torch.Tensor) -> torch.Tensor:
    """A placed cache leaf as this data rank's rows, whole along every
    other dim (a dim split over "model" gathered)."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).to_local()


def _cut_seq(cache, mesh: Mesh, kv_seq_axis) -> list:
    """This rank's part of a cache of its data rank's rows: dim 1 of the
    leaves of rank 3 or more split over ``kv_seq_axis`` where it divides
    them (``cache_specs``' rule; no communication)."""
    k = mesh.shape.get(kv_seq_axis, 1) if kv_seq_axis else 1
    if k == 1:
        return cache
    c = mesh.coordinate(kv_seq_axis)
    return [{n: torch.chunk(t, k, dim=1)[c]
             if t.ndim >= 3 and t.shape[1] % k == 0 else t
             for n, t in blk.items()} for blk in cache]


@contextlib.contextmanager
def _split_model(model: LM, mesh: Mesh):
    """The model on this rank's shards, its compute split over "model"
    (``parallel.tensor_parallel``), without gradients."""
    split = split_of(mesh)
    with torch.no_grad(), local_params(model, split), use_split(split):
        yield model


def lower_cell(cfg: ArchConfig, shape_name: Union[str, ShapeSpec],
               mesh: Mesh, kv_seq_axis=None, remat: bool = True,
               accum: int = 1, seq_parallel: bool = False,
               extra_flags: Dict[str, Any] | None = None
               ) -> Tuple[Callable[[], Dict[str, Any]], Dict[str, Any]]:
    """Builds one (arch x shape) cell's placed state under
    ``FakeTensorMode``; returns (``trace``, aux): ``trace()`` runs the
    cell's step once and returns its flops, memory and collectives; aux
    holds ``model_flops`` and ``state_bytes``, the local bytes of the
    parameters (and, to train, of ``m`` and ``v``), with
    ``state_leaves``, their count. ``shape_name`` is a ``SHAPES`` name
    or a ``ShapeSpec``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = _shape(shape_name)
    extra = extra_flags or {}
    if shape.kind == "decode" and extra.get("kv_quant"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    B, S = shape.global_batch, shape.seq_len
    fake = FakeTensorMode()
    with fake:
        model = LM(torch.Generator().manual_seed(0), cfg)
        shardings = train_state_shardings(cfg, mesh, model)
        if shape.kind == "train":
            state = init_train_state(model, shardings)
        else:   # parameters alone: no optimizer state to place
            state = elastic_remesh(TrainState(model.eval(),
                                              AdamWState({}, {}, 0), 0),
                                   shardings)
        batch, n_local = _local_batch(cfg, mesh, B, S)
    state_tree = [model] + ([state.opt.m, state.opt.v]
                            if shape.kind == "train" else [])
    aux = {"model_flops": model_flops(cfg, shape),
           "state_bytes": _nbytes(state_tree),
           "state_leaves": len(_locals(state_tree))}

    if shape.kind == "train":
        seq_spec = P(batch_axes(mesh), "model", None) if seq_parallel \
            else None
        step = make_train_step(cfg, remat=remat, accum=accum,
                               seq_spec=seq_spec, mesh=mesh)

        def run():
            return step(state, batch)
        args = [state_tree, batch]
    elif shape.kind == "prefill":
        if cfg.is_decoder:
            def run():
                with _split_model(model, mesh):
                    logits, cache = prefill(model, cfg, batch, cache_len=S)
                return logits, _cut_seq(cache, mesh, kv_seq_axis)
        else:
            def run():   # the encoder's forward (it has no decode)
                with _split_model(model, mesh):
                    return forward(model, cfg, batch, mode="train",
                                   remat=False)[0]
        args = [model, batch]
    else:
        with fake:
            cache = init_cache(cfg, B, S, device="cpu")
            c_shard = cache_specs(mesh, cache, B, kv_seq_axis=kv_seq_axis)
            cache = [{k: s[k].place(t) for k, t in blk.items()}
                     for blk, s in zip(cache, c_shard)]
            token = torch.zeros((n_local, 1), dtype=torch.long)
            pos = torch.zeros((n_local,), dtype=torch.long)

        def run():
            with _split_model(model, mesh):
                local = [{k: _batch_only(t) for k, t in blk.items()}
                         for blk in cache]
                logits, new = decode_step(model, cfg, token, local, pos)
            return logits, _cut_seq(new, mesh, kv_seq_axis)
        args = [model, token, cache, pos]

    def trace() -> Dict[str, Any]:
        from torch.utils.flop_counter import FlopCounterMode
        known = _locals(args)
        with fake, mesh_context(mesh):
            flops = FlopCounterMode(display=False)
            with flops, StepTrace(known) as rec, \
                    record_collectives() as split_events:
                out = run()
            memory = {"argument_size_in_bytes": _nbytes(args),
                      "output_size_in_bytes": _nbytes(out),
                      "temp_size_in_bytes": float(rec.peak)}
        return {"cost": {"flops": float(flops.get_total_flops())},
                "memory": memory, "events": rec.events + split_events}
    return trace, aux


def lower_imc_search(mesh: Mesh, population: int = 8192):
    """The paper's own technique as a dry-run cell: one rank's rows of a
    population scored by the IMC cost model (``core.scoring``), its
    ``population / n`` rows of a population split over every device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..api import (PAPER_4, Objective, ScorerSpec, build_scorer,
                       get_space, get_workload_set, pack)
    space = get_space("rram")
    wl = pack(get_workload_set(PAPER_4))
    built = build_scorer(space, ScorerSpec(Objective("edap", "max"),
                                           workloads=wl), device="cpu")
    rows = population // mesh.size
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        genomes = torch.zeros((rows, space.n_params), dtype=torch.long)

    def trace() -> Dict[str, Any]:
        from torch.utils.flop_counter import FlopCounterMode
        with fake:
            flops = FlopCounterMode(display=False)
            with flops, StepTrace([genomes]) as rec:
                out = built.score(genomes)
        return {"cost": {"flops": float(flops.get_total_flops())},
                "memory": {"argument_size_in_bytes": _nbytes(genomes),
                           "output_size_in_bytes": _nbytes(out),
                           "temp_size_in_bytes": float(rec.peak)},
                "events": rec.events}
    # model flops ~ the cost model's tensor algebra; tiny — report 0
    return trace, {"model_flops": 0.0}


def run_cell(arch: str, shape_name: Union[str, ShapeSpec], mesh: Mesh,
             mesh_name: str, out_dir: str, kv_seq_axis=None,
             remat: bool = True, tag: str = "",
             cache_sharding: str = "auto", accum: int = 1,
             seq_parallel: bool = False, kv_quant: bool = False
             ) -> Dict[str, Any]:
    """One cell's record (written to ``out_dir`` when given);
    ``shape_name`` is a ``SHAPES`` name or a ``ShapeSpec``. Either
    ``cache_sharding`` places the cache by ``cache_specs`` (the module
    docstring says why)."""
    t0 = time.perf_counter()
    if arch == "imc_search":
        trace, aux = lower_imc_search(mesh)
    else:
        trace, aux = lower_cell(get_config(arch), shape_name, mesh,
                                kv_seq_axis=kv_seq_axis, remat=remat,
                                accum=accum, seq_parallel=seq_parallel,
                                extra_flags={"kv_quant": kv_quant})
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    traced = trace()
    t_compile = time.perf_counter() - t0
    coll = collective_bytes(traced["events"])
    name = shape_name if isinstance(shape_name, str) else shape_name.name
    rec = {
        "arch": arch, "shape": name, "mesh": mesh_name, "tag": tag,
        "n_devices": int(mesh.size),
        "lower_s": t_lower, "compile_s": t_compile,
        "cost": traced["cost"], "memory": traced["memory"],
        "collective_bytes": coll,
        "collective_total": float(sum(coll.values())),
        "model_flops": aux["model_flops"],
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{name}__{mesh_name}"
        if tag:
            fname += f"__{tag}"
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def all_cells() -> List[Tuple[str, str]]:
    """``--all``'s cells: every runnable (arch x shape), then
    ``imc_search``; the skipped ones printed with their reason."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s, spec in SHAPES.items():
            ok, why = cell_runnable(cfg, spec)
            if ok:
                cells.append((a, s))
            else:
                print(f"SKIP {a} x {s}: {why}")
    cells.append(("imc_search", "population"))
    return cells


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0), torn
    down after the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-seq-axis", default=None)
    ap.add_argument("--cache-sharding", default="auto",
                    choices=["auto", "batch"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    meshes = []
    if args.both_meshes or not args.multi_pod:
        meshes.append(("pod256", False))
    if args.both_meshes or args.multi_pod:
        meshes.append(("pods2x256", True))

    if args.all:
        cells = all_cells()
    else:
        assert args.arch
        cells = [(args.arch,
                  args.shape or ("population" if args.arch == "imc_search"
                                 else "train_4k"))]

    if args.cache_sharding == "auto" and any(
            shape in SHAPES and SHAPES[shape].kind == "decode"
            for _, shape in cells):
        print("--cache-sharding auto: the port has no partitioner to choose "
              "the cache's layout; it is placed by cache_specs, as with "
              "batch")
    failures = 0
    for mesh_name, multi in meshes:
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape in cells:
                label = f"{arch} x {shape} on {mesh_name}"
                try:
                    rec = run_cell(arch, shape, mesh, mesh_name, args.out,
                                   kv_seq_axis=args.kv_seq_axis,
                                   remat=not args.no_remat, tag=args.tag,
                                   cache_sharding=args.cache_sharding,
                                   accum=args.accum,
                                   seq_parallel=args.seq_parallel,
                                   kv_quant=args.kv_quant)
                    c = rec["cost"]
                    print(f"OK   {label}: trace {rec['compile_s']:.1f}s "
                          f"flops {c.get('flops', float('nan')):.3e} "
                          f"coll {rec['collective_total']:.3e}B")
                except Exception:
                    failures += 1
                    print(f"FAIL {label}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()
