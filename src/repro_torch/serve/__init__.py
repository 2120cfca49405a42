"""Serving: the LM engine (``engine.py``) and the co-design search
service (``codesign.py``); counterpart of ``repro/serve/``. The
supported import path for both is the ``repro_torch.api`` facade."""
from .engine import LMRequest, ServeEngine

__all__ = ["LMRequest", "ServeEngine", "CodesignService"]


def __getattr__(name: str):
    if name == "CodesignService":
        # lazy: the search service pulls the experiments stack, which
        # LM-only users of ServeEngine do not need
        from .codesign import CodesignService
        return CodesignService
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
