"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``: its cell list, its flags, its
record's keys and ``model_flops`` formulas; the collective counter, the
memory record and every cell kind on tiny configs in a 4-rank fake
process group (one process, nothing allocated); one production cell,
``xlstm_350m x decode_32k`` on the 256-rank pod, in a subprocess, as
tests/test_dryrun_small.py runs the reference's."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ArchConfig, param_specs
from repro_torch.parallel.sharding import zero1_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SRC = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")


def _tiny():
    return ArchConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                      vocab_size=101, dtype="float32")


@pytest.fixture
def tiny(monkeypatch):
    """``run_cell("tiny", ...)`` takes the tiny config."""
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: _tiny()
                        if a == "tiny" else real(a))
    return _tiny()


def _reference_function(name):
    tree = ast.parse(open(REF_SRC).read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def test_all_cells_are_the_reference_cells(capsys):
    """``--all``'s cells: the reference's runnable (arch x shape) pairs in
    its order (``repro.configs``), then ``imc_search``; the skips
    printed."""
    from repro.configs import ARCH_IDS, SHAPES as JSHAPES, cell_runnable
    from repro.configs import get_config as jget_config
    want = [(a, s) for a in ARCH_IDS for s, spec in JSHAPES.items()
            if cell_runnable(jget_config(a), spec)[0]]
    want.append(("imc_search", "population"))
    assert dryrun.all_cells() == want
    skipped = len(ARCH_IDS) * len(JSHAPES) - (len(want) - 1)
    assert capsys.readouterr().out.count("SKIP ") == skipped > 0


def test_model_flops_are_the_reference_formulas():
    """Every runnable cell's ``model_flops`` is the reference's formula
    (``lower_cell``: 6 N B S, 2 N B S, 2 N B) on the reference's
    config."""
    from repro.configs import get_config as jget_config
    for arch, shape in dryrun.all_cells()[:-1]:
        n = jget_config(arch).active_param_count()
        s = SHAPES[shape]
        want = {"train": 6.0 * n * s.global_batch * s.seq_len,
                "prefill": 2.0 * n * s.global_batch * s.seq_len,
                "decode": 2.0 * n * s.global_batch}[s.kind]
        assert dryrun.model_flops(get_config(arch), s) == want, (arch, shape)


def test_record_keys_and_flags_are_the_reference_ones(tmp_path, tiny):
    """The record's keys are those of the reference's ``run_cell`` dict,
    its memory keys among the reference's ``_mem_dict`` keys, and the
    command line takes every flag of the reference's ``main``."""
    run_cell = _reference_function("run_cell")
    rec = next(n.value for n in ast.walk(run_cell)
               if isinstance(n, ast.Assign) and n.targets[0].id == "rec")
    want_keys = [k.value for k in rec.keys]
    flags = sorted(n.args[0].value for n in ast.walk(
        _reference_function("main")) if isinstance(n, ast.Call)
        and getattr(n.func, "attr", "") == "add_argument")
    assert len(flags) == 13
    mem_keys = next(n.value for n in ast.walk(_reference_function(
        "_mem_dict")) if isinstance(n, ast.Assign)
        and n.targets[0].id == "keys")
    with dryrun.fake_world(4):
        got = dryrun.run_cell("tiny", ShapeSpec("t", 8, 4, "decode"),
                              make_host_mesh(model=2), "fake4",
                              str(tmp_path))
    assert list(got) == want_keys
    assert set(got["memory"]) <= {e.value for e in mem_keys.elts}
    assert set(got["collective_bytes"]) == set(dryrun.COLLECTIVES)
    files = os.listdir(tmp_path)
    assert files == ["tiny__t__fake4.json"]
    assert json.load(open(tmp_path / files[0])) == got
    import argparse
    seen = []
    real = argparse.ArgumentParser.add_argument

    def spy(self, *a, **k):
        seen.append(a[0])
        return real(self, *a, **k)
    argparse.ArgumentParser.add_argument = spy
    try:
        with pytest.raises(SystemExit):
            dryrun.main(["--help"])
    finally:
        argparse.ArgumentParser.add_argument = real
    assert sorted(f for f in seen if f.startswith("--") and f != "--help") \
        == flags


def test_collective_bytes_of_a_dtensor_program():
    """A hand-built program on a 4-rank fake group, under
    ``FakeTensorMode``: each functional collective's result bytes under
    its reference name; an op that is no collective adds nothing."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(4):
        dm = init_device_mesh("cpu", (4,))   # reads its ranks: no fakes
        g = dm.get_group()
        with FakeTensorMode(), dryrun.StepTrace() as rec:
            x = distribute_tensor(torch.zeros(64, 8), dm, [Shard(0)],
                                  src_data_rank=None)
            y = torch.zeros(16, 8, dtype=torch.bfloat16)
            x.redistribute(dm, [Replicate()]).to_local()  # 64 x 8 x 4 B
            funcol.all_reduce(y, "sum", g)                # 16 x 8 x 2 B
            funcol.reduce_scatter_tensor(y, "sum", 0, g)  # 4 x 8 x 2 B
            funcol.all_to_all_single(y, None, None, g)    # 16 x 8 x 2 B
            y + 1
    got = dryrun.collective_bytes(rec.events)
    assert got == {"all-gather": 64 * 8 * 4.0, "all-reduce": 16 * 8 * 2.0,
                   "reduce-scatter": 4 * 8 * 2.0,
                   "all-to-all": 16 * 8 * 2.0, "collective-permute": 0.0}


def test_train_cell_argument_bytes_are_the_shards(tiny):
    """A tiny train cell on a (2, 2) fake mesh: argument bytes the hand
    sum of every parameter's shard, ``m`` and ``v``'s float32 ZeRO-1
    shards and this data rank's rows of the batch; output bytes the new
    state and the three 0-dim metrics; temp above the whole parameters'
    bytes (the activations of 4 rows); flops counted; the data ranks'
    float32 gradient sums reduce-scattered (at least the ZeRO-1 parts of
    the leaves ``m`` splits over "data"), and fewer bytes all-gathered
    than the whole parameters hold (no rank gathers them all)."""
    cfg = tiny
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2)
        rec = dryrun.run_cell("tiny", ShapeSpec("t", 16, 8, "train"), mesh,
                              "fake4", "", accum=2)
    specs = param_specs(cfg, 2)
    from repro_torch.models import init_params
    shapes = {n: tuple(p.shape) for n, p in init_params(
        torch.Generator().manual_seed(0), cfg).named_parameters()}
    mv = zero1_specs(specs, {n: torch.empty(s, device="meta")
                             for n, s in shapes.items()}, mesh)

    def numel(shape, spec):
        n = 1
        for d, part in zip(shape, list(spec) + [None] * len(shape)):
            n *= d // (mesh.shape[part] if part else 1)
        return n
    params = sum(4 * numel(s, specs[n]) for n, s in shapes.items())
    moments = sum(2 * 4 * numel(s, mv[n]) for n, s in shapes.items())
    batch = 2 * (8 // 2) * 16 * 4
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == params + moments + batch
    assert mem["output_size_in_bytes"] == params + moments + 3 * 4
    whole = sum(4 * torch.Size(s).numel() for s in shapes.values())
    assert mem["temp_size_in_bytes"] > whole
    assert rec["cost"]["flops"] > 0
    parts = sum(4 * numel(s, mv[n]) for n, s in shapes.items()
                if "data" in mv[n])
    assert rec["collective_bytes"]["reduce-scatter"] >= parts > 0
    assert 0 < rec["collective_bytes"]["all-gather"] < whole
    assert rec["n_devices"] == 4


def _wide():
    """2 layers of d 64, 4 heads, ff 256, vocab 128: every product
    splits over 4 ranks."""
    return ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
                      vocab_size=128, dtype="float32")


def test_train_cell_flops_split_over_model(monkeypatch):
    """A tiny train cell (``_wide``) on a fake (1, 4) group counts at most
    1/3 of the flops a rank that it counts on the 1 x 1 mesh: the
    products run on each rank's shards."""
    from repro_torch.launch.mesh import Mesh
    monkeypatch.setattr(dryrun, "get_config", lambda a: _wide())
    shape = ShapeSpec("t", 16, 8, "train")
    one = dryrun.run_cell("tiny", shape, Mesh((1, 1), ("data", "model")),
                          "one", "")
    with dryrun.fake_world(4):
        split = dryrun.run_cell("tiny", shape, make_host_mesh(model=4),
                                "fake4", "")
    assert 0 < split["cost"]["flops"] <= one["cost"]["flops"] / 3
    assert split["collective_bytes"]["all-reduce"] > 0


def test_rank_ordered_reduce_scatter_bytes():
    """``parallel.tensor_parallel``'s rank-ordered reduce-scatter on a
    4-rank fake group is recorded once, as a reduce-scatter with its
    part's bytes (the ``all_to_all_single`` it is made of is not
    counted); its all-reduce as an all-reduce with the whole's bytes; a
    plain DTensor gather still under its own name."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch.distributed as dist
    from repro_torch.parallel import tensor_parallel as tp
    with dryrun.fake_world(4):
        g = dist.group.WORLD
        with FakeTensorMode(), dryrun.StepTrace() as rec, \
                tp.record_collectives() as events:
            x = torch.zeros(64, 8)
            assert tp.reduce_scatter(x, 0, g, 4).shape == (16, 8)
            assert tp.all_reduce(torch.zeros(5, 3), g, 4).shape == (5, 3)
            assert tp.all_gather(torch.zeros(2, 3), 1, g, 4).shape == (2, 12)
    got = dryrun.collective_bytes(rec.events + events)
    assert got == {"all-gather": 2 * 12 * 4.0, "all-reduce": 5 * 3 * 4.0,
                   "reduce-scatter": 16 * 8 * 4.0, "all-to-all": 0.0,
                   "collective-permute": 0.0}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_trace(kind, tiny):
    """Prefill and decode cells of a tiny config with the cache's slots
    over "model" (``--kv-seq-axis model``) and the int8 cache: flops and
    all-gathers counted, the output bytes those of this rank's logits
    and its part of the cache."""
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2)
        rec = dryrun.run_cell("tiny", ShapeSpec("s", 16, 8, kind), mesh,
                              "fake4", "", kv_seq_axis="model",
                              kv_quant=True)
    assert rec["cost"]["flops"] > 0
    assert rec["collective_bytes"]["all-gather"] > 0
    logits = 4 * 101 * 4
    assert rec["memory"]["output_size_in_bytes"] > logits


def test_xlstm_decode_cell_on_the_pod(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch xlstm_350m --shape
    decode_32k`` in a subprocess: one record, 256 devices, flops
    counted (the reference's tests/test_dryrun_small.py cell)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm_350m", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["xlstm_350m__decode_32k__pod256.json"]
    rec = json.loads(files[0].read_text())
    assert rec["n_devices"] == 256
    assert rec["cost"]["flops"] > 0
    assert rec["compile_s"] > 0
    assert rec["collective_bytes"]["all-gather"] > 0
