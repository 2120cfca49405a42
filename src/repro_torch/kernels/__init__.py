"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. A wrapper launches its CUDA kernel on CUDA tensors and runs
the plain version on CPU tensors; kernels build at first use
(``build.py``)."""
from .adc import WEIGHT_BITS, adc_full_scale, adc_quantize
from .imc_fused import imc_fused_gemm, imc_fused_plain
# the wrapper ``imc_matmul`` stays in its module: re-exporting it here
# would shadow the submodule ``kernels.imc_matmul`` of the same name
from .imc_matmul import imc_matmul_plain
from .ops import imc_gemm
