"""Bit-exact threefry2x32 counter-based RNG, as ``jax.random`` draws it.

In this system the noise is part of the *model*: the accuracy model
draws every design's conductance noise from ``fold_in(k_noise,
flat_index(design))``, so a design's score is a pure function of the
design. The port therefore reproduces JAX's generator bit for bit
instead of using a ``torch.Generator``: the same key gives the same
bits, the same uniforms and the same genomes on both sides.

Mode: JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5). Keys
are ``(..., 2)`` tensors of uint32 values held in ``torch.int64`` with
32-bit masking (torch's uint32 coverage is partial). Every function
takes a batch of keys in its leading dimensions; a batch of keys
behaves like ``jax.vmap`` over the unbatched call.

Counterparts in ``jax/_src/prng.py``: ``threefry_seed``,
``_threefry2x32_lowering``, ``iota_2x32_shape``,
``_threefry_split_foldlike``, ``threefry_fold_in`` and
``_threefry_random_bits_partitionable``; in ``jax/_src/random.py``:
``_uniform``, ``_randint``, ``_normal_real``, ``_bernoulli``,
``_shuffle`` (``permutation``) and ``choice`` without replacement.

``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's single-precision
``erf_inv`` polynomial (Giles), whose Horner steps XLA contracts into
fused multiply-adds. It matches ``jax.random.normal`` to a few ULP, not
bitwise: ``torch.log1p`` and XLA's CPU ``log1p`` round differently on a
fraction of inputs (measured in ``tests/test_torch_random.py``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s)
                                                             for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the count pair ``(x1, x2)`` under the key
    ``(k1, k2)``; all four broadcast, values in ``[0, 2^32)``."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    a = (x1 + k1) & _M32
    b = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _key_halves(key: torch.Tensor, n_dims: int):
    if key.shape[-1] != 2 or key.dtype != torch.int64:
        raise TypeError("a key is an int64 tensor of shape (..., 2)")
    pad = (None,) * n_dims
    k1 = key[..., 0][(...,) + pad]
    k2 = key[..., 1][(...,) + pad]
    return k1, k2


def _iota(shape: Tuple[int, ...], device) -> torch.Tensor:
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2^32 draws from one key")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    k1, k2 = _key_halves(key, 1)
    lo = _iota((num,), key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: mixes 32-bit ``data`` (an int or an integer
    tensor broadcasting against the key's batch) into the key."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit random words: ``(..., 2)`` keys -> ``(..., *shape)``."""
    shape = _shape(shape)
    k1, k2 = _key_halves(key, len(shape))
    lo = _iota(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``: the 23 high bits become
    the mantissa of a float in ``[1, 2)``, minus one, scaled. The bounds
    are rounded to float32 and their difference taken in float32, as
    JAX does (Python floats, so no host-to-device copy)."""
    return _uniform_of_bits(random_bits(key, shape), minval, maxval)


def _uniform_of_bits(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"): one polynomial for w = -log1p(-x^2) < 5, one in sqrt(w).
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941],
                       np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _fma(a, b, c) -> torch.Tensor:
    # float32 fused multiply-add: the float64 product of two float32
    # values is exact, so one rounding of the sum to float32 remains.
    # An operand may be a Python float holding a float32 value
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    return (a * b + c).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial and operation
    order (Horner steps as fused multiply-adds)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, float(_ERFINV_LT5[0]), float(_ERFINV_GE5[0]))
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, torch.where(lt, float(_ERFINV_LT5[i]),
                                   float(_ERFINV_GE5[i])))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """``normal``'s transform of its 32-bit words (int64 tensor of values
    in ``[0, 2^32)``): a uniform in ``[nextafter(-1, 0), 1)``, then
    ``sqrt(2) * erf_inv``. The CUDA kernels' device copy of it is
    ``csrc/threefry.cuh``."""
    return _SQRT2 * erf_inv(_uniform_of_bits(bits, _NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """Standard-normal float32 draws (``jax.random.normal``)."""
    return normal_of_bits(random_bits(key, shape))


def bernoulli(key: torch.Tensor, p, shape: Shape) -> torch.Tensor:
    """``uniform < p`` with ``p`` a float32 probability: a Python float
    or a float32 tensor broadcasting against the draws."""
    if not isinstance(p, torch.Tensor):
        p = float(np.float32(p))
    return uniform(key, shape) < p


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for values in ``[0, 2^32)`` without int64
    overflow (split ``b`` into 16-bit halves)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` by JAX's two-word modulus
    method (``jax.random.randint`` with the default int32 dtype)."""
    minval, maxval = int(minval), int(maxval)
    if not (-(2 ** 31) <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint bounds must fit in int32")
    ks = split(key)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (_mul32(higher % span, torch.full_like(higher, mult))
           + lower % span) & _M32
    off = off % span
    return (minval + off).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``(..., 2)`` keys -> ``(...,
    n)`` int32 shuffles of ``arange(n)``. JAX's ``_shuffle``: a fixed
    number of rounds, ``ceil(3 ln(max(1, n)) / ln(2^32 - 1))`` (one up to
    n of about 1600), each splitting the key and stably sorting the
    values by fresh 32-bit words. The words stay unsigned in int64, so
    the sort sees JAX's uint32 order."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(float(_M32))))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        *key.shape[:-1], n)
    for _ in range(rounds):
        ks = split(key)
        key = ks[..., 0, :]
        order = torch.argsort(random_bits(ks[..., 1, :], (n,)), dim=-1,
                              stable=True)
        x = torch.gather(x, -1, order)
    return x.to(torch.int32)


def choice(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first
    ``k`` entries of ``permutation(key, n)``, ``(..., k)`` int32."""
    if not 0 <= int(k) <= int(n):
        raise ValueError(f"cannot draw {k} of {n} without replacement")
    return permutation(key, n)[..., :int(k)]
