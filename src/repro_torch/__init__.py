"""PyTorch/CUDA port of the IMC hardware-workload co-optimization
system (``repro`` is the JAX reference it is held against).

The port imports ``torch``, never ``jax``, and nothing of ``repro``.
Its entry points run on the GPU (``device="cuda"``) unless the caller
passes ``device="cpu"``; its hot kernel, the fused noisy-crossbar GEMM,
is hand-written CUDA for Hopper (``csrc/imc_fused.cu``).
"""
