"""The port's LM-model package: the architecture config (it also feeds
``configs/`` and ``core.workloads.from_arch_config``) and the decoder
stack (``attn``/``local_attn`` blocks, the int8 KV cache, ``rglru``,
``mlstm`` and ``slstm`` blocks with ``recurrent.py``) that serves
qwen3-4b, qwen2.5-3b, glm4-9b, phi4-mini, recurrentgemma-9b and
xlstm-350m. MoE, cross attention and the encoder follow (ROADMAP Queue 1
item 13)."""
from .config import ArchConfig
from .transformer import (apply_block, decode_step, forward, init_cache,
                          init_params, loss_fn, prefill)
from .attention import blockwise_attention, decode_attention
from . import layers, recurrent
