"""Training over a sharded mesh (``train.loop.make_train_step(...,
mesh=)``), ``elastic_remesh``, the checkpoint across meshes and the
launcher under several ranks, in gloo CPU processes.

The bar is bit for bit: the compute runs whole on every rank, so a
(1, M) mesh is the one-process step, and a (D, M) mesh the
one-process step with ``accum=D`` over the data ranks' batches in rank
order (their float32 gradient sums are added in that order, as the
microbatches' are). Each rank holds only its shard of every sharded
parameter and of ``m`` and ``v``. Against the reference's jitted step on
its 2-device (1, 2) host mesh (run in a subprocess, which forces 2 host
devices before JAX starts), the port's (1, 2) step is held within
tests/test_torch_train.py's bounds for three train steps.

Ranks are spawned processes on a file store with a join timeout, as
tests/test_torch_parallel.py's; the jobs of each world size run in turn
in one spawned world (the module fixtures ``worlds`` and ``launched``),
and each test checks its job's results. A rank imports this module,
which imports no JAX at its top."""
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
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_host_mesh, mesh_context
from repro_torch.models import ArchConfig, init_params, loss_fn, param_specs
from repro_torch.parallel.sharding import (P, is_placed, whole,
                                           zero1_specs)
from repro_torch.train import loop

JOIN_TIMEOUT_S = 90
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


def _fresh(cfg, seed=0):
    return loop.init_train_state(
        init_params(torch.Generator().manual_seed(seed), cfg))


def _placed(cfg, mesh, seed=0):
    state = _fresh(cfg, seed)
    return loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, mesh, state.params))


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


def _run_steps(state, step_fn, batches, data_rank):
    hist = []
    for b in batches:
        state, m = step_fn(state, b[data_rank])
        hist.append((float(m["loss"]), float(m["grad_norm"])))
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
    mesh = make_host_mesh(model=M)
    state = _placed(cfg, mesh)
    before = _local_shapes(state, cfg, mesh)
    step_fn = loop.make_train_step(cfg, accum=payload["accum"], mesh=mesh,
                                   **STEP_KW)
    state, hist = _run_steps(state, step_fn, payload["batches"],
                             mesh.coordinate("data"))
    final = _whole_state(state)
    return {"shapes": before, "after": _local_shapes(state, cfg, mesh),
            "hist": hist, "state": final if rank == 0 else None,
            "step": state.step, "count": state.opt.count}


def _job_remesh(rank, world, payload):
    """Step 1 on (2, 2); then (1, 4) with the step at accum 2 on the
    whole batch, (4, 1), and 1 x 1: the whole state after each remesh,
    the local shapes on each mesh, and the state after step 2."""
    cfg = payload["cfg"]
    b = payload["batches"]
    out = {"whole": [], "shapes": []}
    m22 = make_host_mesh(model=2)
    state = _placed(cfg, m22)
    state, _ = _run_steps(state, loop.make_train_step(cfg, mesh=m22,
                                                      **STEP_KW),
                          b[:1], m22.coordinate("data"))
    out["whole"].append(_whole_state(state))
    m14 = make_host_mesh(model=4)
    state = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, m14, state.params))
    out["whole"].append(_whole_state(state))
    out["shapes"].append(_local_shapes(state, cfg, m14))
    joined = {k: np.concatenate([r[k] for r in b[1]]) for k in b[1][0]}
    state, _ = loop.make_train_step(cfg, accum=2, mesh=m14, **STEP_KW)(
        state, joined)
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


_JOBS = {"steps": _job_steps, "remesh": _job_remesh,
         "ckpt_save": _job_ckpt_save, "ckpt_restore": _job_ckpt_restore,
         "launcher": _job_launcher, "many": _job_many}


def _one_process(cfg, batches, accum):
    """The one-process step: each step's batch the data ranks' parts
    joined in rank order."""
    state = _fresh(cfg)
    step_fn = loop.make_train_step(cfg, accum=accum, **STEP_KW)
    hist = []
    for b in batches:
        joined = {k: np.concatenate([r[k] for r in b]) for k in b[0]}
        state, m = step_fn(state, joined)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return _whole_state(state), hist


def _assert_same(got, want, what=""):
    assert got.keys() == want.keys()
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert bad == [], f"{what}: leaves that differ: {bad[:6]}"


# ---------------------------------------------------------------------------
# the worlds: the jobs of each world size run in one spawned world
# ---------------------------------------------------------------------------

STEP_CASES = [(1, 2, "float32"), (1, 4, "float32"), (2, 1, "float32"),
              (2, 2, "float32"), (2, 2, "bfloat16")]


def _steps_payload(data, model, dtype):
    cfg = _cfg(dtype)
    return {"cfg": cfg, "model": model, "accum": 1,
            "batches": _batches(cfg, data, 3)}


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
def worlds(tmp_path_factory):
    """The 4-rank jobs (the (1, 4) and (2, 2) steps, the remesh, the
    checkpoint's save on (2, 2)) in one world, then the 2-rank ones (the
    (1, 2) and (2, 1) steps, accumulation, the checkpoint's restore on
    (1, 2)) in another."""
    ck = tmp_path_factory.mktemp("ck")
    jobs = {4: {}, 2: {}}
    for case in STEP_CASES:
        jobs[case[0] * case[1]][case] = ("steps", _steps_payload(*case))
    jobs[4]["remesh"] = ("remesh", _remesh_payload())
    jobs[4]["ckpt_save"] = ("ckpt_save", _ckpt_payload(ck))
    jobs[2]["accum"] = ("steps", _accum_payload())
    jobs[2]["ckpt_restore"] = ("ckpt_restore", {"cfg": _cfg("bfloat16"),
                                                "model": 2, "dir": str(ck)})
    out = {"ck": ck}
    for world in (4, 2):
        out.update(_run_world(world, jobs[world],
                              tmp_path_factory.mktemp(f"world{world}")))
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,dtype", STEP_CASES)
def test_mesh_step_is_the_one_process_step(data, model, dtype, worlds):
    """Three steps on a (data, model) gloo mesh: losses, grad norms, every
    parameter, m and v bit for bit the one-process step at accum = data
    over the data ranks' batches joined; each rank's every leaf of the
    local size its spec's shard has, before and after; the counters
    stepped."""
    payload = _steps_payload(data, model, dtype)
    out = worlds[(data, model, dtype)]
    want, hist = _one_process(payload["cfg"], payload["batches"],
                              accum=data)
    _assert_same(out[0]["state"], want, f"({data}, {model})")
    for r, o in enumerate(out):
        assert o["hist"] == hist, (r, o["hist"], hist)
        assert o["step"] == o["count"] == 3
        for name, local, shard in o["shapes"] + o["after"]:
            assert local == shard, (r, name, local, shard)
    # the mesh shards something: every rank holds less than the whole
    if model > 1 or data > 1:
        for o in out:
            held = sum(int(np.prod(s)) for _, s, _ in o["shapes"])
            full = sum(int(np.prod(v.shape)) for v in want.values())
            assert held < full


def test_mesh_step_with_accumulation(worlds):
    """accum 2 on a (1, 2) mesh: bit for bit the one-process accum-2
    step."""
    payload = _accum_payload()
    out = worlds["accum"]
    want, hist = _one_process(payload["cfg"], payload["batches"], accum=2)
    _assert_same(out[0]["state"], want)
    assert out[0]["hist"] == out[1]["hist"] == hist


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


# ---------------------------------------------------------------------------
# elastic_remesh and the checkpoint
# ---------------------------------------------------------------------------

def test_elastic_remesh_over_four_meshes(worlds):
    """(2, 2) -> (1, 4) -> (4, 1) -> 1 x 1 in 4 ranks: the whole state
    bit for bit after every remesh, each rank's leaves the shards of the
    new mesh, plain tensors on 1 x 1; a step on (1, 4) after the remesh
    (accum 2 over the whole batch) bit for bit the straight run's
    second step on (2, 2)."""
    payload = _remesh_payload()
    cfg, batches = payload["cfg"], payload["batches"]
    out = worlds["remesh"]
    straight, _ = _one_process(cfg, batches, accum=2)
    one_step, _ = _one_process(cfg, batches[:1], accum=2)
    for r, o in enumerate(out):
        _assert_same(o["whole"][0], one_step, f"rank {r} (2, 2)")
        for i, w in enumerate(o["whole"][1:]):
            _assert_same(w, straight if i else o["whole"][0],
                         f"rank {r} remesh {i + 1}")
        _assert_same(o["stepped"], straight, f"rank {r} step on (1, 4)")
        assert o["plain"]
        for shapes in o["shapes"]:
            for name, local, shard in shapes:
                assert local == shard, (r, name, local, shard)


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
weights, out = sys.argv[1:]
cfg = get_config("qwen3_4b", reduced=True)
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
def test_mesh_step_matches_the_reference_mesh_step(tmp_path):
    """The reference's jitted step on ``make_host_mesh(model=2)`` (2
    forced host devices, parameters placed by their specs) and the
    port's on a (1, 2) gloo mesh, from the same weights
    (``convert.from_reference_lm_params``) on the pipeline's batches:
    three steps' losses and grad norms rtol 1e-5, every parameter within
    2e-3 lr a step taken where the reference's AdamW step was
    well-conditioned and 2 lr where it was not (tests/test_torch_train.py
    states why)."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import init_params as jinit_params
    from repro_torch import convert
    jcfg = jget_config("qwen3_4b", reduced=True)
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
        [sys.executable, "-c", _REFERENCE_RUN, str(tmp_path / "w.npz"),
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
