"""Training over a sharded mesh (``train.loop.make_train_step(...,
mesh=)``), ``elastic_remesh``, the checkpoint across meshes and the
launcher under several ranks, in gloo CPU processes.

Over "data" alone the bar is bit for bit: a (D, 1) mesh is the
one-process step with ``accum=D`` over the data ranks' batches in rank
order (their float32 gradient sums are added in that order by a
rank-ordered reduce-scatter, as the microbatches' are, and the clip's
norm is summed in float64 from each rank's parts). Over "model" the
compute is split (``models/split.py``): partial sums over a dim of the
model are added across ranks, so each step of a (D, M > 1) run is held
to the one-process step from the same state within a bound
(``_check_step``: losses and grad norms rtol 1e-5, every parameter
within 2e-3 lr where the one-process AdamW step is well-conditioned and
2 lr where it is not; a bfloat16 model too, since each split product's
partial sums are added in float32 and rounded once), for every block
kind at M = 2 and 4; every rank of a model group holds the same bits,
run to run. Each rank holds only its shard of every sharded parameter and of
``m`` and ``v``. Against the reference's jitted step on its 2-device
(1, 2) host mesh (run in a subprocess, which forces 2 host devices
before JAX starts), the port's (1, 2) step is held within
tests/test_torch_train.py's bounds for three train steps, for qwen3-4b,
llama-3.2-vision and mixtral-8x22b.

Ranks are spawned processes on a file store with a join timeout, as
tests/test_torch_parallel.py's; the jobs of each world size run in turn
in one spawned world (the module fixtures ``worlds`` and ``launched``),
and each test checks its job's results. A rank imports this module,
which imports no JAX at its top."""
import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, list_steps, restore, save
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_host_mesh, mesh_context
from repro_torch.models import ArchConfig, init_params, loss_fn, param_specs
from repro_torch.parallel.sharding import (P, is_placed, whole,
                                           zero1_specs)
from repro_torch.train import loop

JOIN_TIMEOUT_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(dtype="float32"):
    """2 layers, narrow; vocab 101 leaves ``unembed`` unsharded, 32 of
    ``embed``'s width splits over 2 or 4."""
    return ArchConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                      vocab_size=101, dtype=dtype)


STEP_KW = dict(peak_lr=1e-2, warmup=2, total_steps=10)


def _batches(cfg, data, n_steps, rows=2, S=12, seed=5):
    """``n_steps`` batches of every data rank: numpy int32 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        toks = rng.integers(0, cfg.vocab_size, (data, rows, S)).astype(
            np.int32)
        out.append([{"tokens": t, "labels": t.copy()} for t in toks])
    return out


def _model(cfg, seed=0, filled=False):
    """``init_params``; ``filled``: every all-zero leaf (norm gains,
    biases, the cross layers' gates) drawn from a seeded normal x 0.2,
    so every leaf takes a gradient."""
    model = init_params(torch.Generator().manual_seed(seed), cfg)
    if filled:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for _, p in model.named_parameters():
                if not p.any():
                    p.copy_(torch.from_numpy(np.asarray(
                        rng.standard_normal(tuple(p.shape)) * 0.2,
                        np.float32)))
    return model


def _fresh(cfg, seed=0, filled=False):
    return loop.init_train_state(_model(cfg, seed, filled))


def _placed(cfg, mesh, seed=0, filled=False):
    model = _model(cfg, seed, filled)
    return loop.init_train_state(model, loop.train_state_shardings(
        cfg, mesh, model))


def _whole_state(state):
    """name -> numpy of every parameter, m and v leaf, whole (a
    collective over the mesh: every rank calls it)."""
    out = {}
    for n, p in state.params.named_parameters():
        out["p." + n] = _np(whole(p))
    for t in ("m", "v"):
        for n, x in getattr(state.opt, t).items():
            out[f"{t}.{n}"] = _np(whole(x))
    return out


def _values(state):
    """name -> float32 numpy of every parameter, m and v leaf, whole (a
    collective over the mesh: every rank calls it)."""
    out = {"p." + n: whole(p).detach().float().numpy().copy()
           for n, p in state.params.named_parameters()}
    for t in ("m", "v"):
        out.update({f"{t}.{n}": whole(x).float().numpy().copy()
                    for n, x in getattr(state.opt, t).items()})
    return out


def _state_from(cfg, values, step):
    """A one-process train state holding ``_values``' parameters, m and
    v, at ``step``."""
    state = _fresh(cfg)
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(torch.from_numpy(values["p." + n]))
        for t in ("m", "v"):
            for n, x in getattr(state.opt, t).items():
                x.copy_(torch.from_numpy(values[f"{t}.{n}"]))
    return loop.TrainState(state.params, loop.AdamWState(
        state.opt.m, state.opt.v, step), step)


def _replicated_digest(state):
    """A digest of this rank's bits of every leaf the "model" axis does
    not split (parameters, m and v): the same on every rank of a model
    group."""
    h = hashlib.sha256()
    leaves = [("p." + n, p) for n, p in state.params.named_parameters()]
    leaves += [(f"{t}.{n}", x) for t in ("m", "v")
               for n, x in getattr(state.opt, t).items()]
    for name, x in leaves:
        if is_placed(x) and any(pl.is_shard() for pl, a in zip(
                x.placements, x.device_mesh.mesh_dim_names) if a == "model"):
            continue
        h.update(name.encode())
        h.update(_np(x.to_local() if is_placed(x) else x).tobytes())
    return h.hexdigest()


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy()
    return t.numpy().copy()


def _local_shapes(state, cfg, mesh):
    """(leaf, local shape, the shard its spec names) of every parameter,
    m and v leaf."""
    specs = param_specs(cfg, mesh.shape["model"])
    shapes = dict(state.params.named_parameters())
    mv = zero1_specs(specs, shapes, mesh)
    rows = []

    def shard(shape, spec):
        out = list(shape)
        for d, part in enumerate(spec):
            if part is not None:
                axes = (part,) if isinstance(part, str) else part
                for a in axes:
                    out[d] //= mesh.shape[a]
        return tuple(out)
    for n, p in state.params.named_parameters():
        local = p.to_local() if is_placed(p) else p
        rows.append((f"p.{n}", tuple(local.shape), shard(p.shape, specs[n])))
    for t in ("m", "v"):
        for n, x in getattr(state.opt, t).items():
            local = x.to_local() if is_placed(x) else x
            rows.append((f"{t}.{n}", tuple(local.shape),
                         shard(x.shape, mv[n])))
    return rows


def _run_steps(state, step_fn, batches, data_rank, values=None):
    """The steps on this data rank's batches: (state, [(loss, grad
    norm)]); the whole ``_values`` after each step appended to
    ``values`` when given."""
    hist = []
    for b in batches:
        state, m = step_fn(state, b[data_rank])
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        if values is not None:
            values.append(_values(state))
    return state, hist


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _spawn(job, world, tmp_path, payload):
    """Runs ``job`` in ``world`` spawned processes (gloo over a file store
    in ``tmp_path``, or none when ``payload["env"]`` asks for torchrun's
    variables), each reading ``payload`` and writing its result; fails
    if any is not done within JOIN_TIMEOUT_S. Returns the results by
    rank."""
    with open(tmp_path / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(job, r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks hung"
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]
    out = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _worker(job, rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    if payload.get("env"):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost")
        out = _JOBS[job](rank, world, payload)
    else:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=world)
        try:
            out = _JOBS[job](rank, world, payload)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _job_steps(rank, world, payload):
    """``payload["steps"]`` steps on make_host_mesh(model=M) with this
    data rank's batches; the local shapes before and after, the losses
    and grad norms, and (rank 0) the whole state."""
    cfg, M = payload["cfg"], payload["model"]
    filled = payload.get("filled", False)
    mesh = make_host_mesh(model=M)
    state = _placed(cfg, mesh, filled=filled)
    before = _local_shapes(state, cfg, mesh)
    step_fn = loop.make_train_step(cfg, accum=payload["accum"], mesh=mesh,
                                   **STEP_KW)
    values = []
    state, hist = _run_steps(state, step_fn, payload["batches"],
                             mesh.coordinate("data"), values)
    final = _whole_state(state)
    out = {"shapes": before, "after": _local_shapes(state, cfg, mesh),
           "hist": hist, "state": final if rank == 0 else None,
           "values": values if rank == 0 else None,
           "digest": _replicated_digest(state),
           "step": state.step, "count": state.opt.count}
    if payload.get("twice"):
        again, hist2 = _run_steps(_placed(cfg, mesh, filled=filled),
                                  step_fn, payload["batches"],
                                  mesh.coordinate("data"))
        again = _whole_state(again)     # a collective: every rank
        out["again"] = (hist2, again if rank == 0 else None)
    return out


def _serve(cfg, model, batch, n_decode=2):
    """Prefill of ``batch`` and ``n_decode`` greedy decode steps of
    ``model`` (its local shards under the current split, if any):
    the last-token logits of each, float32 numpy."""
    from repro_torch.models import decode_step, prefill
    tokens = torch.as_tensor(batch["tokens"]).long()
    inputs = {"tokens": tokens}
    if "image_embeds" in batch:
        inputs["image_embeds"] = torch.as_tensor(batch["image_embeds"])
    B, S = tokens.shape
    with torch.no_grad():
        logits, cache = prefill(model, cfg, inputs, S + n_decode)
        out = [logits]
        for t in range(n_decode):
            tok = out[-1].argmax(-1)[:, None]
            pos = torch.full((B,), S + t, dtype=torch.long)
            logits, cache = decode_step(model, cfg, tok, cache, pos)
            out.append(logits)
    return [o.float().numpy().copy() for o in out]


def _job_serve(rank, world, payload):
    """Prefill and greedy decode steps of the filled reduced config on a
    (1, model) mesh, its compute split over "model" (the cache whole on
    every rank): each step's last-token logits."""
    from repro_torch.parallel.tensor_parallel import (local_params, split_of,
                                                      use_split)
    cfg = payload["cfg"]
    mesh = make_host_mesh(model=payload["model"])
    model = _model(cfg, filled=True).eval()
    state = loop.elastic_remesh(
        loop.TrainState(model, loop.AdamWState({}, {}, 0), 0),
        loop.train_state_shardings(cfg, mesh, model))
    split = split_of(mesh)
    with local_params(state.params, split), use_split(split):
        return _serve(cfg, state.params, payload["batch"])


def _job_remesh(rank, world, payload):
    """Step 1 on (2, 2); then (1, 4) with the step at accum 2 on the
    whole batch, (4, 1), and 1 x 1: the whole state after each remesh,
    the local shapes on each mesh, and the state after step 2."""
    cfg = payload["cfg"]
    b = payload["batches"]
    out = {"whole": [], "shapes": [], "values": []}
    m22 = make_host_mesh(model=2)
    state = _placed(cfg, m22)
    state, out["hist"] = _run_steps(state, loop.make_train_step(
        cfg, mesh=m22, **STEP_KW), b[:1], m22.coordinate("data"),
        out["values"])
    out["whole"].append(_whole_state(state))
    m14 = make_host_mesh(model=4)
    state = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, m14, state.params))
    out["whole"].append(_whole_state(state))
    out["shapes"].append(_local_shapes(state, cfg, m14))
    joined = {k: np.concatenate([r[k] for r in b[1]]) for k in b[1][0]}
    state, hist = _run_steps(state, loop.make_train_step(
        cfg, accum=2, mesh=m14, **STEP_KW), [[joined]], 0, out["values"])
    out["hist"] += hist
    out["stepped"] = _whole_state(state)
    m41 = make_host_mesh(model=1)
    state = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, m41, state.params))
    out["whole"].append(_whole_state(state))
    out["shapes"].append(_local_shapes(state, cfg, m41))
    one = Mesh((1, 1), ("data", "model"))
    state = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, one, state.params))
    out["plain"] = all(not is_placed(x) for x in list(
        state.params.parameters()) + list(state.opt.m.values())
        + list(state.opt.v.values()))
    out["whole"].append(_whole_state(state))
    return out


def _job_ckpt_save(rank, world, payload):
    cfg = payload["cfg"]
    mesh = make_host_mesh(model=payload["model"])
    state = _placed(cfg, mesh)
    state, _ = _run_steps(state, loop.make_train_step(cfg, mesh=mesh,
                                                      **STEP_KW),
                          payload["batches"], mesh.coordinate("data"))
    save(payload["dir"], 2, state)
    return _whole_state(state)


def _job_ckpt_restore(rank, world, payload):
    cfg = payload["cfg"]
    mesh = make_host_mesh(model=payload["model"])
    fresh = _placed(cfg, mesh, seed=1)
    back = restore(payload["dir"], 2, fresh)
    return {"whole": _whole_state(back), "step": back.step,
            "count": back.opt.count,
            "shapes": _local_shapes(back, cfg, mesh)}


def _job_launcher(rank, world, payload):
    """``launch.train.main`` once for each of ``payload["argvs"]`` under
    torchrun's variables (a port each), each rank first removing the
    files ``payload["remove"]`` lists for it before that run: the group
    starts only when every rank has, and a run reads its checkpoints
    after that."""
    outs = []
    for port, argv, remove in zip(payload["ports"], payload["argvs"],
                                  payload["remove"]):
        for path in remove.get(rank, []):
            os.remove(path)
        os.environ["MASTER_PORT"] = str(port)
        outs.append(launch_train.main(argv))
    return outs


def _job_many(rank, world, payload):
    """Each of ``payload["jobs"]`` ((name, payload) pairs) in turn in this
    one world; their results in order."""
    import torch.distributed as dist
    outs = []
    for name, sub in payload["jobs"]:
        outs.append(_JOBS[name](rank, world, sub))
        dist.barrier()
    return outs


_JOBS = {"steps": _job_steps, "remesh": _job_remesh, "serve": _job_serve,
         "ckpt_save": _job_ckpt_save, "ckpt_restore": _job_ckpt_restore,
         "launcher": _job_launcher, "many": _job_many}


def _one_process(cfg, batches, accum):
    """The one-process step: each step's batch the data ranks' parts
    joined in rank order. (the whole state's bits, [(loss, grad
    norm)])."""
    state = _fresh(cfg)
    step_fn = loop.make_train_step(cfg, accum=accum, **STEP_KW)
    joined = [{k: np.concatenate([r[k] for r in b]) for k in b[0]}
              for b in batches]
    state, hist = _run_steps(state, step_fn, [[b] for b in joined], 0)
    return _whole_state(state), hist


def _assert_same(got, want, what=""):
    assert got.keys() == want.keys()
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert bad == [], f"{what}: leaves that differ: {bad[:6]}"


def _check_step(got, want, count, what=""):
    """One split step against the one-process step from the same state:
    ``got`` and ``want`` are ((loss, grad norm), ``_values`` after it),
    ``count`` AdamW's count after it.
    Losses and grad norms rtol 1e-5; every parameter within 2e-3 lr
    where the one-process AdamW step is well-conditioned and 2 lr where
    it is not (its bias-corrected m in (0, 1e-6): m / sqrt(v) then turns
    a gradient's last bits into a step of up to lr), the rule of
    test_mesh_step_matches_the_reference_mesh_step. The same bound holds
    a bfloat16 model: the split adds each product's partial sums in
    float32 and rounds them once, as the whole product does."""
    lr = STEP_KW["peak_lr"]
    (hist, values), (want_hist, want) = got, want
    np.testing.assert_allclose(hist, want_hist, rtol=1e-5, err_msg=what)
    for key, w in want.items():
        if not key.startswith("p."):
            continue
        diff = np.abs(values[key] - w)
        m_hat = np.abs(want["m." + key[2:]]) / (1.0 - 0.9 ** count)
        ill = (m_hat > 0) & (m_hat < 1e-6)
        bound = np.where(ill, 2 * lr, 2e-3 * lr)
        assert (diff <= bound).all(), (what, key, float(diff.max()))


def _assert_steps_within_bound(cfg, batches, accum, hist, values, what,
                               filled=False):
    """A run split over "model" (its (loss, grad norm) and ``_values``
    after each step) against the one-process step at ``accum`` over each
    step's data ranks' batches joined, step by step from the same state:
    the first from the same init, each next one from the split run's
    parameters, m and v after the step before (so AdamW's amplification
    of last bits does not add up over steps); ``_check_step`` each."""
    step_fn = loop.make_train_step(cfg, accum=accum, **STEP_KW)
    state = _fresh(cfg, filled=filled)
    assert len(hist) == len(values) == len(batches)
    for t, b in enumerate(batches):
        if t:
            state = _state_from(cfg, values[t - 1], t)
        joined = {k: np.concatenate([r[k] for r in b]) for k in b[0]}
        state, m = step_fn(state, joined)
        _check_step((hist[t], values[t]),
                    ((float(m["loss"]), float(m["grad_norm"])),
                     _values(state)), t + 1, f"{what} step {t}")


# ---------------------------------------------------------------------------
# the worlds: the jobs of each world size run in one spawned world
# ---------------------------------------------------------------------------

STEP_CASES = [(1, 1, "float32"), (1, 2, "float32"), (1, 4, "float32"),
              (2, 1, "float32"), (2, 2, "float32"), (2, 2, "bfloat16")]


def _steps_payload(data, model, dtype):
    cfg = _cfg(dtype)
    return {"cfg": cfg, "model": model, "accum": 1,
            "batches": _batches(cfg, data, 3)}


# one reduced config of each block kind: dense with q/k norms, GQA with
# fewer KV heads than ranks (glm4-9b's 2 at M = 4), MoE, RG-LRU beside
# local attention, mLSTM and sLSTM, cross attention, the audio encoder,
# and a config whose 3 heads neither M divides (wq's rows split)
SPLIT_ARCHS = ("qwen3_4b", "glm4_9b", "mixtral_8x22b", "recurrentgemma_9b",
               "xlstm_350m", "llama32_vision_11b", "hubert_xlarge",
               "qwen3_4b_3_heads")
SPLIT_CASES = [(a, m) for m in (2, 4) for a in SPLIT_ARCHS]
SPLIT_STEPS = 2


def _split_cfg(arch):
    if arch == "qwen3_4b_3_heads":
        return dataclasses.replace(get_config("qwen3_4b", reduced=True),
                                   n_heads=3, n_kv_heads=1)
    return get_config(arch, reduced=True)


# the decoders among them, served split (hubert has no decode step)
SERVE_CASES = [(a, m) for a, m in SPLIT_CASES if a != "hubert_xlarge"]


def _serve_payload(arch, model):
    cfg = _split_cfg(arch)
    pipe = SyntheticTokenPipeline(cfg, 2, 12, seed=4, process_index=0,
                                  process_count=1)
    return {"cfg": cfg, "model": model, "batch": pipe.next_batch()}


def _split_payload(arch, model):
    """``SPLIT_STEPS`` steps of the reduced ``arch`` on a (1, model) mesh
    from filled weights, on its pipeline's batches (tokens, frames,
    image embeddings), run twice."""
    cfg = _split_cfg(arch)
    pipe = SyntheticTokenPipeline(cfg, 2, 16, seed=3, process_index=0,
                                  process_count=1)
    return {"cfg": cfg, "model": model, "accum": 1, "filled": True,
            "twice": True,
            "batches": [[pipe.next_batch()] for _ in range(SPLIT_STEPS)]}


def _accum_payload():
    cfg = _cfg()
    return {"cfg": cfg, "model": 2, "accum": 2,
            "batches": _batches(cfg, 1, 2, rows=4)}


def _remesh_payload():
    cfg = _cfg()
    return {"cfg": cfg, "batches": _batches(cfg, 2, 2)}


def _ckpt_payload(ck):
    cfg = _cfg("bfloat16")
    return {"cfg": cfg, "model": 2, "batches": _batches(cfg, 2, 2),
            "dir": str(ck)}


def _run_world(world, jobs, tmp):
    """``jobs`` ({key: (job name, payload)}) in one spawned world of
    ``world`` ranks; {key: the results by rank}."""
    keys = list(jobs)
    out = _spawn("many", world, tmp, {"jobs": [jobs[k] for k in keys]})
    return {k: [o[i] for o in out] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def split_worlds(tmp_path_factory):
    """The ``SPLIT_CASES`` jobs: those of M = 4 in one 4-rank world, then
    those of M = 2 in a 2-rank world."""
    out = {}
    for world in (4, 2):
        jobs = {(a, m): ("steps", _split_payload(a, m))
                for a, m in SPLIT_CASES if m == world}
        jobs.update({("serve", a, m): ("serve", _serve_payload(a, m))
                     for a, m in SERVE_CASES if m == world})
        out.update(_run_world(world, jobs,
                              tmp_path_factory.mktemp(f"split{world}")))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 4-rank jobs (the (1, 4) and (2, 2) steps, the remesh, the
    checkpoint's save on (2, 2)) in one world, then the 2-rank ones (the
    (1, 2) and (2, 1) steps, accumulation, the checkpoint's restore on
    (1, 2)) in another."""
    ck = tmp_path_factory.mktemp("ck")
    jobs = {4: {}, 2: {}}
    for case in STEP_CASES:
        if case[0] * case[1] > 1:
            jobs[case[0] * case[1]][case] = ("steps", _steps_payload(*case))
    jobs[4]["remesh"] = ("remesh", _remesh_payload())
    jobs[4]["ckpt_save"] = ("ckpt_save", _ckpt_payload(ck))
    jobs[2]["accum"] = ("steps", _accum_payload())
    jobs[2]["ckpt_restore"] = ("ckpt_restore", {"cfg": _cfg("bfloat16"),
                                                "model": 2, "dir": str(ck)})
    out = {"ck": ck, (1, 1, "float32"): [
        _job_steps(0, 1, _steps_payload(1, 1, "float32"))]}
    for world in (4, 2):
        out.update(_run_world(world, jobs[world],
                              tmp_path_factory.mktemp(f"world{world}")))
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,dtype", STEP_CASES)
def test_mesh_step_is_the_one_process_step(data, model, dtype, worlds):
    """Three steps on a (data, model) gloo mesh (1 x 1: one process, no
    group) against the one-process step at accum = data over the data
    ranks' batches joined: over "data" alone losses, grad norms, every
    parameter, m and v bit for bit; split over "model" within
    ``_assert_steps_within_bound``, every rank with the same losses and grad
    norms; each rank's every leaf of the local size its spec's shard
    has, before and after; the counters stepped."""
    payload = _steps_payload(data, model, dtype)
    out = worlds[(data, model, dtype)]
    if model == 1:
        want, hist = _one_process(payload["cfg"], payload["batches"],
                                  accum=data)
        _assert_same(out[0]["state"], want, f"({data}, {model})")
    else:
        hist = out[0]["hist"]
        _assert_steps_within_bound(payload["cfg"], payload["batches"], data,
                                   hist, out[0]["values"],
                                   f"({data}, {model})")
    for r, o in enumerate(out):
        assert o["hist"] == hist, (r, o["hist"], hist)
        assert o["step"] == o["count"] == 3
        for name, local, shard in o["shapes"] + o["after"]:
            assert local == shard, (r, name, local, shard)
    # the mesh shards something: every rank holds less than the whole
    if model > 1 or data > 1:
        for o in out:
            held = sum(int(np.prod(s)) for _, s, _ in o["shapes"])
            full = sum(int(np.prod(v.shape))
                       for v in out[0]["state"].values())
            assert held < full


def test_mesh_step_with_accumulation(worlds):
    """accum 2 on a (1, 2) mesh: the one-process accum-2 step within
    ``_assert_steps_within_bound``, both ranks with the same losses."""
    payload = _accum_payload()
    out = worlds["accum"]
    _assert_steps_within_bound(payload["cfg"], payload["batches"], 2,
                               out[0]["hist"], out[0]["values"], "accum 2")
    assert out[0]["hist"] == out[1]["hist"]


@pytest.mark.parametrize("arch,model", SPLIT_CASES)
def test_split_step_of_each_block_kind(arch, model, split_worlds):
    """The reduced ``arch`` (filled weights) trains ``SPLIT_STEPS`` steps
    on a (1, model) gloo mesh, its compute split over "model": each step
    within ``_assert_steps_within_bound`` of the one-process step from
    the same state; each rank's leaves of their specs' local shapes."""
    payload = _split_payload(arch, model)
    out = split_worlds[(arch, model)]
    _assert_steps_within_bound(payload["cfg"], payload["batches"], 1,
                               out[0]["hist"], out[0]["values"],
                               f"{arch} (1, {model})", filled=True)
    for r, o in enumerate(out):
        for name, local, shard in o["shapes"] + o["after"]:
            assert local == shard, (r, name, local, shard)


@pytest.mark.parametrize("arch,model", SPLIT_CASES)
def test_split_step_is_the_same_on_every_rank_run_to_run(arch, model,
                                                        split_worlds):
    """Every rank of the model group: the same losses and grad norms, and
    the same bits of every leaf "model" does not split (its replicated
    parameters, their m and v); a second run from the same state gives
    the same bits again."""
    out = split_worlds[(arch, model)]
    for r, o in enumerate(out):
        assert o["hist"] == out[0]["hist"], r
        assert o["digest"] == out[0]["digest"], r
        assert o["again"][0] == o["hist"], r
    _assert_same(out[0]["again"][1], out[0]["state"], f"{arch} again")


def test_seq_spec_is_neutral_and_checked():
    """``seq_spec`` changes no bit of the loss or of a step under the host
    mesh; an axis the mesh lacks, or no current mesh, raises."""
    cfg = _cfg()
    b = _batches(cfg, 1, 1)[0][0]
    batch = {k: torch.as_tensor(v).long() for k, v in b.items()}
    model = init_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_host_mesh()
    spec = P(("data",), "model", None)
    with mesh_context(mesh):
        a, pa = loss_fn(model, cfg, batch)
        s, ps = loss_fn(model, cfg, batch, seq_spec=spec)
        assert torch.equal(a, s) and torch.equal(pa["ce"], ps["ce"])
        finals = []
        for seq_spec in (None, spec):
            state, m = loop.make_train_step(cfg, seq_spec=seq_spec,
                                            mesh=mesh, **STEP_KW)(
                _fresh(cfg), b)
            finals.append((m["loss"], _whole_state(state)))
        assert torch.equal(finals[0][0], finals[1][0])
        _assert_same(finals[1][1], finals[0][1])
        with pytest.raises(ValueError, match="no mesh axis"):
            loss_fn(model, cfg, batch, seq_spec=P("pod", None, None))
    with pytest.raises(ValueError, match="current mesh"):
        loss_fn(model, cfg, batch, seq_spec=spec)


@pytest.mark.parametrize("arch,model", SERVE_CASES)
def test_split_prefill_and_decode_of_each_block_kind(arch, model,
                                                     split_worlds):
    """A prefill and two greedy decode steps of the filled reduced
    ``arch`` on a (1, model) gloo mesh, split over "model" (attention by
    heads reading the whole cache's KV heads, the recurrent states
    gathered whole into the cache after each step): each step's logits
    the same on every rank and within 1e-4 of the one-process run's
    (whose greedy tokens they pick too)."""
    payload = _serve_payload(arch, model)
    out = split_worlds[("serve", arch, model)]
    want = _serve(payload["cfg"], _model(payload["cfg"], filled=True).eval(),
                  payload["batch"])
    for r, got in enumerate(out):
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, out[0][t], err_msg=f"rank {r}")
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                       err_msg=f"{arch} step {t}")
            assert (g.argmax(-1) == w.argmax(-1)).all(), (arch, t)


# ---------------------------------------------------------------------------
# elastic_remesh and the checkpoint
# ---------------------------------------------------------------------------

def test_elastic_remesh_over_four_meshes(worlds):
    """(2, 2) -> (1, 4) -> (4, 1) -> 1 x 1 in 4 ranks: the whole state
    bit for bit after every remesh, each rank's leaves the shards of the
    new mesh, plain tensors on 1 x 1; the step on (2, 2) and a step on
    (1, 4) after the remesh (accum 2 over the whole batch) within
    ``_assert_steps_within_bound`` of the one-process run's two steps."""
    payload = _remesh_payload()
    cfg, batches = payload["cfg"], payload["batches"]
    out = worlds["remesh"]
    for r, o in enumerate(out):
        for i, w in enumerate(o["whole"][1:]):
            _assert_same(w, o["stepped"] if i else o["whole"][0],
                         f"rank {r} remesh {i + 1}")
        assert o["hist"] == out[0]["hist"]
        assert o["plain"]
        for shapes in o["shapes"]:
            for name, local, shard in shapes:
                assert local == shard, (r, name, local, shard)
    _assert_steps_within_bound(cfg, batches, 2, out[0]["hist"],
                               out[0]["values"], "(2, 2) then (1, 4)")


def test_checkpoint_of_four_ranks_restored_in_two(worlds):
    """A state trained 2 steps by 4 ranks on (2, 2) and saved (a file a
    rank) is restored by 2 ranks on (1, 2) into a fresh placed state,
    and by one process into plain tensors: every leaf bit for bit, the
    counters, each rank's shards of its own mesh."""
    cfg = _cfg("bfloat16")
    ck, saved, back = worlds["ck"], worlds["ckpt_save"], \
        worlds["ckpt_restore"]
    assert sorted(os.listdir(ck)) == [f"step_00000002_p{r}.npz"
                                      for r in range(4)]
    for o in back:
        _assert_same(o["whole"], saved[0], "restored on (1, 2)")
        assert o["step"] == o["count"] == 2
        for name, local, shard in o["shapes"]:
            assert local == shard, (name, local, shard)
    plain = restore(str(ck), 2, _fresh(cfg, seed=1))
    _assert_same(_whole_state(plain), saved[0], "restored in one process")


def _placed_file(path, mesh):
    np.savez(path, __placed__=np.asarray(json.dumps({"mesh": mesh})))


def test_latest_step_is_the_newest_step_every_rank_saved(tmp_path):
    """Steps 2 and 4 saved by both ranks of a (1, 2) mesh and step 6 by
    rank 0 alone (a run that died between the two ranks' saves):
    ``latest_step`` is 4, and collecting old steps keeps step 6 and the
    newest whole steps; once rank 1's file of step 6 is there it is 6."""
    for step, ranks in ((2, (0, 1)), (4, (0, 1)), (6, (0,))):
        for r in ranks:
            _placed_file(tmp_path / f"step_{step:08d}_p{r}.npz", [1, 2])
    assert list_steps(str(tmp_path)) == [2, 4, 6]
    assert latest_step(str(tmp_path)) == 4
    # a plain save of step 5 with keep 2: steps 4 and 5 are the newest
    # whole ones, so only step 2 goes; step 6 stays
    save(str(tmp_path), 5, {"x": torch.zeros(2)}, keep=2)
    assert list_steps(str(tmp_path)) == [4, 5, 6]
    assert latest_step(str(tmp_path)) == 5
    _placed_file(tmp_path / "step_00000006_p1.npz", [1, 2])
    assert latest_step(str(tmp_path)) == 6


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


LAUNCH = ["--arch", "qwen3_4b", "--reduced", "--device", "cpu", "--batch",
          "2", "--seq", "8", "--model-shards", "2", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``launch.train`` runs under 2 torchrun-style ranks, in order: "a"
    straight to step 4; "b" to 2, then the same command to 4; "c"
    straight to 4, then, with rank 1's file of step 4 removed (a run
    that died between the two ranks' saves of step 4), the same command
    again. Returns the directories and the exit codes by rank."""
    tmp = tmp_path_factory.mktemp("launch")
    a, b, c = (str(tmp / d) for d in "abc")
    argvs = [LAUNCH + ["--steps", "4", "--ckpt-dir", a],
             LAUNCH + ["--steps", "2", "--ckpt-dir", b],
             LAUNCH + ["--steps", "4", "--ckpt-dir", b],
             LAUNCH + ["--steps", "4", "--ckpt-dir", c],
             LAUNCH + ["--steps", "4", "--ckpt-dir", c]]
    remove = [{}, {}, {}, {},
              {1: [os.path.join(c, "step_00000004_p1.npz")]}]
    (tmp / "run").mkdir()
    rcs = _spawn("launcher", 2, tmp / "run",
                 {"env": True, "ports": _free_ports(len(argvs)),
                  "argvs": argvs, "remove": remove})
    return {"a": a, "b": b, "c": c, "rcs": rcs}


def _assert_same_files(x_dir, y_dir, step, ranks):
    for r in range(ranks):
        with np.load(os.path.join(x_dir, f"step_{step:08d}_p{r}.npz")) as x, \
                np.load(os.path.join(y_dir, f"step_{step:08d}_p{r}.npz")) \
                as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            meta = json.loads(str(x["__placed__"]))
            assert meta["mesh"] == [1, 2] and meta["coord"] == [0, r]


def test_launcher_under_two_ranks_resumes_bitwise(launched):
    """``launch.train --model-shards 2 --device cpu`` under torchrun's
    variables in 2 processes: it starts its gloo group, trains on the
    (1, 2) mesh and checkpoints; 2 steps, then a rerun of the same
    command to 4, writes the step-4 files of the straight run to 4, bit
    for bit, rank by rank."""
    assert launched["rcs"] == [[0] * 5] * 2
    _assert_same_files(launched["a"], launched["b"], 4, 2)


def test_launcher_resumes_from_the_last_step_every_rank_saved(launched):
    """With rank 1's file of step 4 gone, a rerun resumes both ranks from
    step 2 (the newest step both saved), not from rank 0's step 4, and
    writes both ranks' step-4 files anew, bit for bit the straight
    run's."""
    assert launched["rcs"] == [[0] * 5] * 2
    assert latest_step(launched["c"]) == 4
    _assert_same_files(launched["a"], launched["c"], 4, 2)


# ---------------------------------------------------------------------------
# against the reference's 2-device mesh step
# ---------------------------------------------------------------------------

_REFERENCE_RUN = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import SyntheticTokenPipeline
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.models import init_params
from repro.parallel.sharding import shardings_from_specs
from repro.train import loop
arch, weights, out = sys.argv[1:]
cfg = get_config(arch, reduced=True)
mesh = make_host_mesh(model=2)
assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
with mesh_context(mesh):
    params, specs = init_params(jax.random.PRNGKey(0), cfg,
                                n_shards=mesh.shape["model"])
    w = np.load(weights)
    paths, tree = jax.tree_util.tree_flatten_with_path(params)
    params = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(w[jax.tree_util.keystr(p)]) for p, _ in paths])
    params = jax.tree.map(jax.device_put, params,
                          shardings_from_specs(mesh, specs))
    state = loop.init_train_state(params)
    step = jax.jit(loop.make_train_step(cfg, peak_lr=1e-2, warmup=2,
                                        total_steps=10))
    pipe = SyntheticTokenPipeline(cfg, 4, 16, seed=3)
    rec = {"n_devices": np.asarray(
        len(state.params["embed"].sharding.device_set))}
    for t in range(3):
        b = pipe.next_batch()
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        rec[f"loss{t}"] = np.asarray(m["loss"])
        rec[f"gnorm{t}"] = np.asarray(m["grad_norm"])
        for name, tr in (("p", state.params), ("m", state.opt.m)):
            for path, x in jax.tree_util.tree_flatten_with_path(tr)[0]:
                rec[f"{name}{t}{jax.tree_util.keystr(path)}"] = np.array(x)
np.savez(out, **rec)
"""


def _job_reference_steps(rank, world, payload):
    from repro_torch import convert
    cfg = payload["cfg"]
    mesh = make_host_mesh(model=2)
    model = convert.from_reference_lm_params(payload["params"], cfg,
                                             device="cpu")
    state = loop.init_train_state(model)
    state = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, mesh, state.params))
    step_fn = loop.make_train_step(cfg, mesh=mesh, **STEP_KW)
    from repro_torch.data import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg, 4, 16, seed=3, process_index=0,
                                  process_count=1)
    hist, params = [], []
    for _ in range(3):
        state, m = step_fn(state, pipe.next_batch())
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        params.append({n: whole(p).float().numpy().copy()
                       for n, p in state.params.named_parameters()})
    return {"hist": hist, "params": params}


_JOBS["reference_steps"] = _job_reference_steps


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen3_4b", "llama32_vision_11b",
                                  "mixtral_8x22b"])
def test_mesh_step_matches_the_reference_mesh_step(arch, tmp_path):
    """The reference's jitted step on ``make_host_mesh(model=2)`` (2
    forced host devices, parameters placed by their specs) and the
    port's on a (1, 2) gloo mesh, its compute split over "model", from
    the same weights (``convert.from_reference_lm_params``) on the
    pipeline's batches: three steps' losses and grad norms rtol 1e-5,
    every parameter within 2e-3 lr a step taken where the reference's
    AdamW step was well-conditioned and 2 lr where it was not
    (tests/test_torch_train.py states why); for the dense qwen3-4b, for
    llama-3.2-vision (cross-attention blocks) and for mixtral-8x22b (the
    experts over ff). ``regroup`` (the RG-LRU's and mLSTM's fused
    projections traded by channel) is held to the one-process step only,
    by test_split_step_of_each_block_kind."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import init_params as jinit_params
    from repro_torch import convert
    jcfg = jget_config(arch, reduced=True)
    cfg = convert.from_reference_arch_config(jcfg)
    # the reference's init with its zero leaves (norm gains) drawn, so
    # every parameter takes a gradient (tests/test_torch_train.py's)
    rng = np.random.default_rng(0)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    np_params = jax.tree.map(fill, jinit_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    np.savez(tmp_path / "w.npz", **{
        jax.tree_util.keystr(p): x for p, x in
        jax.tree_util.tree_flatten_with_path(np_params)[0]})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    path = str(tmp_path / "ref.npz")
    # the reference and the port's ranks run side by side
    ref_run = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_RUN, arch, str(tmp_path / "w.npz"),
         path], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    (tmp_path / "run").mkdir()
    try:
        out = _spawn("reference_steps", 2, tmp_path / "run",
                     {"cfg": cfg, "params": np_params})
        log, _ = ref_run.communicate(timeout=300)
    finally:
        ref_run.kill()
    assert ref_run.returncode == 0, log
    ref = dict(np.load(path))
    assert int(ref["n_devices"]) == 2
    assert out[0]["hist"] == out[1]["hist"]
    lr = STEP_KW["peak_lr"]
    ill = {}    # elements whose AdamW step has been ill-conditioned
    for t in range(3):
        loss, gnorm = out[0]["hist"][t]
        np.testing.assert_allclose(loss, float(ref[f"loss{t}"]), rtol=1e-5)
        np.testing.assert_allclose(gnorm, float(ref[f"gnorm{t}"]),
                                   rtol=1e-5)
        bc1 = 1.0 - 0.9 ** (t + 1)
        got = dict(jax.tree_util.tree_flatten_with_path(
            convert.to_reference_lm_tree(
                {n: torch.from_numpy(x) for n, x in
                 out[0]["params"][t].items()}, cfg))[0])
        for path in got:
            key = jax.tree_util.keystr(path)
            m_hat = np.abs(ref[f"m{t}{key}"]) / bc1
            ill[key] = ill.get(key, False) | (
                (m_hat > 0) & (m_hat < 100 * 1e-8))
            diff = np.abs(np.asarray(got[path], np.float32)
                          - ref[f"p{t}{key}"].astype(np.float32))
            bound = np.where(ill[key], 2 * lr, 2e-3 * lr) * (t + 1)
            assert (diff <= bound).all(), (t, key, float(diff.max()))
