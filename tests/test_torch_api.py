"""repro_torch.api: the port's public facade is complete, keeps its own
copy of the wire schema, loads the service and the LM stack lazily, and
the modules of this slice import neither JAX nor the reference."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.api as japi
import repro_torch.api as api

ROOT = Path(__file__).resolve().parents[1]


def test_all_exports_resolve():
    """Every __all__ name imports (the lazy serve-layer ones included)
    and dir() advertises them; an unknown name raises."""
    for name in api.__all__:
        assert getattr(api, name) is not None, name
        assert name in dir(api)
    with pytest.raises(AttributeError, match="no attribute"):
        api.not_a_real_export


def test_facade_matches_the_reference_surface():
    """The same ``__all__`` as repro.api, the same schema version and
    statuses, and the same fields on each frozen wire type."""
    assert api.__all__ == japi.__all__
    assert api.API_SCHEMA_VERSION == japi.API_SCHEMA_VERSION == 1
    assert set(api.RESPONSE_STATUSES) == {"completed", "cancelled",
                                          "expired", "failed"}
    assert api.RESPONSE_STATUSES == japi.RESPONSE_STATUSES
    for name in ("SearchRequest", "ProgressEvent", "SearchResponse",
                 "ServiceStats"):
        ours, ref = getattr(api, name), getattr(japi, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref)], name
        assert ours.__dataclass_params__.frozen


def test_schema_types_come_from_api_not_serve():
    """The wire schema lives in the facade; the service imports it from
    there."""
    from repro_torch.serve import codesign, engine
    assert codesign.SearchRequest is api.SearchRequest
    assert codesign.SearchResponse is api.SearchResponse
    assert codesign.ProgressEvent is api.ProgressEvent
    assert api.LMRequest is engine.LMRequest
    assert api.CodesignService is codesign.CodesignService


def test_api_module_is_light_on_serve():
    """Importing repro_torch.api loads neither the service nor the LM
    model stack; asking for CodesignService loads the service."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.api; "
            "assert 'repro_torch.serve.codesign' not in sys.modules, 'svc'; "
            "assert 'repro_torch.serve.engine' not in sys.modules, 'eng'; "
            "assert 'repro_torch.models' not in sys.modules, 'models'; "
            "from repro_torch.api import CodesignService; "
            "assert 'repro_torch.serve.codesign' in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("rel", ["core/distributed.py",
                                 "experiments/campaign.py",
                                 "serve/codesign.py", "api.py"])
def test_new_modules_import_neither_jax_nor_reference(rel):
    """AST scan of this slice's modules: no ``jax``/``jaxlib`` and no
    ``repro``/``repro.*`` import."""
    path = ROOT / "src" / "repro_torch" / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    n_imports = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the package
                n_imports += 1
                continue
            mods = [node.module or ""]
        else:
            continue
        n_imports += 1
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{rel}: imports {mod}"
    assert n_imports >= 3


def test_entry_points_default_to_cuda(tmp_path):
    """The campaign and its pieces default to device='cuda' and raise
    without a GPU instead of running on the CPU."""
    import torch
    from repro_torch.core import distributed
    from repro_torch.experiments import campaign, get_scenario
    if torch.cuda.is_available():
        assert distributed.lane_devices()[0].type == "cuda"
        return
    sc = get_scenario("sram_smoke")
    for call in (lambda: campaign.run_campaign([sc], out_dir=str(tmp_path)),
                 lambda: campaign.plan_campaign([sc], write=False),
                 lambda: distributed.lane_devices(),
                 lambda: distributed.compile_batched_search(
                     lambda d, x: x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.listdir(tmp_path)
