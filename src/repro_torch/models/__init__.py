"""The port's LM-model package. Only the architecture config is ported
so far (it feeds ``configs/`` and ``core.workloads.from_arch_config``);
the LM stack follows later (ROADMAP Queue 1 item 13)."""
from .config import ArchConfig
