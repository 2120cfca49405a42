"""LM serving; counterpart of ``repro/serve/`` (the engine; the
co-design service is ROADMAP Queue 1 item 11)."""
from .engine import LMRequest, ServeEngine
