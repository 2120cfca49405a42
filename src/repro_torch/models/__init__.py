"""The port's LM-model package: the architecture config (it also feeds
``configs/`` and ``core.workloads.from_arch_config``) and the LM stack
(``attn``/``local_attn`` blocks, the int8 KV cache, ``cross_attn``
blocks with the vision frontend, the audio frontend and the
bidirectional encoder, ``rglru``, ``mlstm`` and ``slstm`` blocks with
``recurrent.py``, the mixture-of-experts FFN with ``moe.py``) that
serves qwen3-4b, qwen2.5-3b, glm4-9b, phi4-mini, recurrentgemma-9b,
xlstm-350m, llama-3.2-vision, phi3.5-moe and mixtral-8x22b, and runs
hubert-xlarge's encoder."""
from .config import ArchConfig
from .transformer import (apply_block, decode_step, forward, init_cache,
                          init_params, loss_fn, param_specs, prefill)
from .attention import blockwise_attention, decode_attention
from . import layers, moe, recurrent
