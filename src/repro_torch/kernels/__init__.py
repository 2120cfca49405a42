"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. A wrapper launches its CUDA kernel on CUDA tensors and runs
the plain version on CPU tensors; kernels build at first use
(``build.py``)."""
from .adc import WEIGHT_BITS, adc_full_scale, adc_quantize
from .flash_attention import flash_attention_plain
from .imc_fused import (SIGMA_POLY, imc_fused_gemm, imc_fused_gemm_keyed,
                        imc_fused_keyed_plain, imc_fused_plain,
                        ir_drop_factor, sigma_of_g)
# the wrappers ``imc_matmul`` and ``flash_attention`` stay in their
# modules: re-exporting them here would shadow the submodules of the
# same names
from .imc_matmul import imc_matmul_plain
from .ops import flash_mha, imc_gemm
from .ref import imc_fused_ref
from . import ref
