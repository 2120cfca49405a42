"""Parity of the port's threefry RNG (repro_torch/random.py) with
jax.random: keys, splits, fold_in, raw bits, uniforms, bernoulli and
randint bit for bit; normal to a few ULP (XLA's CPU log1p inside
erf_inv rounds differently from torch.log1p on a small fraction of
inputs), on every uniform it can make and in the fused kernel's keyed
output-noise draw."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.kernels.imc_fused import imc_fused_keyed_plain

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 1003, 20260415, 2 ** 31 - 1)


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.numpy()


def test_jax_threefry_mode_is_partitionable():
    """The port reproduces the partitionable threefry streams; a JAX
    upgrade that changes the default must fail here first."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bitwise(seed):
    jk, k = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    assert np.array_equal(np.asarray(jk), _np(k))
    for num in (2, 3, 5):
        assert np.array_equal(np.asarray(jax.random.split(jk, num)),
                              _np(jr.split(k, num)))
    for data in (0, 1, 12345, 2 ** 31 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)),
                              _np(jr.fold_in(k, data)))
    # a batch of fold_in data, as the accuracy model folds design indices
    flat = np.array([0, 7, 99, 12_000_000], np.int32)
    want = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(flat))
    assert np.array_equal(np.asarray(want),
                          _np(jr.fold_in(k, torch.from_numpy(flat))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (5, 9), (24, 9), (32, 256),
                                   (2, 11, 9)])
def test_bits_and_uniform_bitwise(seed, shape):
    jk, k = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(bits, _np(jr.random_bits(k, shape)))
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          _np(jr.uniform(k, shape)))
    assert np.array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=-1.0, maxval=1.0)),
        _np(jr.uniform(k, shape, -1.0, 1.0)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_randint_bitwise(seed):
    jk, k = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    for p in (0.05, 0.5, 0.9):
        assert np.array_equal(
            np.asarray(jax.random.bernoulli(jk, np.float32(p), (23, 9))),
            _np(jr.bernoulli(k, p, (23, 9))))
    # GA tournament draws (P = 8, 24, 120) and activation codes
    for shape, hi in (((2, 6), 8), ((2, 22), 24), ((2, 118), 120),
                      ((4, 64), 256), ((300,), 7)):
        assert np.array_equal(
            np.asarray(jax.random.randint(jk, shape, 0, hi)),
            _np(jr.randint(k, shape, 0, hi)))
    assert np.array_equal(np.asarray(jax.random.randint(jk, (50,), -3, 4)),
                          _np(jr.randint(k, (50,), -3, 4)))


def test_batched_keys_match_vmap():
    """A leading batch of keys behaves like jax.vmap over one key."""
    seeds = (0, 5, 1000, 1003)
    jks = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    ks = torch.stack([jr.PRNGKey(s) for s in seeds])
    for fn_j, fn_t in (
            (lambda k: jax.random.split(k, 3), lambda k: jr.split(k, 3)),
            (lambda k: jax.random.uniform(k, (6, 9)),
             lambda k: jr.uniform(k, (6, 9))),
            (lambda k: jax.random.randint(k, (2, 10), 0, 24),
             lambda k: jr.randint(k, (2, 10), 0, 24)),
            (lambda k: jax.random.bernoulli(k, np.float32(0.3), (10, 1)),
             lambda k: jr.bernoulli(k, 0.3, (10, 1)))):
        assert np.array_equal(np.asarray(jax.vmap(fn_j)(jks)), _np(fn_t(ks)))


def test_normal_within_4_ulp():
    """normal = sqrt(2) * erf_inv(u) with XLA's Giles polynomial. On
    1M draws the port matched jax.random.normal bitwise on 99.06% of
    values, worst 3 ULP; the floor below leaves room for other keys."""
    n = 1 << 20
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (n,)))
    got = _np(jr.normal(jr.PRNGKey(7), (n,)))
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
    assert np.mean(ulp == 0) >= 0.98
    # the calibration-weight and eps-field shapes of the accuracy model
    for seed, shape in ((3, (256, 32)), (11, (4, 256, 32))):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = _np(jr.normal(jr.PRNGKey(seed), shape))
        np.testing.assert_allclose(got, want, rtol=4 * 2 ** -23, atol=1e-30)


def test_normal_of_bits_within_4_ulp_on_every_uniform():
    """``normal``'s transform on each of the 2^23 uniforms it can make
    (the 23 high bits of a word; the device copy in csrc/threefry.cuh is
    held to it on the card) against sqrt(2) * jax.lax.erf_inv of the
    same uniforms, which are bitwise JAX's (test above)."""
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9
    got = _np(jr.normal_of_bits(bits))
    u = _np(jr._uniform_of_bits(bits, jr._NORMAL_LO, 1.0))
    want = np.float32(np.sqrt(2.0)) * np.asarray(
        jax.lax.erf_inv(jnp.asarray(u)))
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert np.isfinite(got).all() and ulp.max() <= 4
    assert np.mean(ulp == 0) >= 0.98


@pytest.mark.parametrize("P,B,N", [(3, 4, 8), (24, 32, 32)])
def test_keyed_output_noise_within_4_ulp(P, B, N):
    """The keyed route's output-noise field z_out (P, B, N) against
    jax.random.normal(split(fold_in(key, flat[p]), 3)[2], (B, N))."""
    rng = np.random.default_rng(P)
    flat = rng.integers(0, 2 ** 31, (P,)).astype(np.int64)
    x_q = torch.from_numpy(rng.integers(0, 256, (B, 64)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(-1, 1, (64, N)).astype(np.float32))
    _, z = imc_fused_keyed_plain(
        x_q, w, jr.PRNGKey(9), torch.from_numpy(flat),
        torch.zeros(P, dtype=torch.int32), torch.tensor([64.0]), sub=64)
    want = jax.vmap(lambda d: jax.random.normal(jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(9), d), 3)[2], (B, N)))(
        jnp.asarray(flat.astype(np.int32)))
    np.testing.assert_allclose(_np(z), np.asarray(want), rtol=4 * 2 ** -23,
                               atol=1e-30)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = _np(jr.erf_inv(x))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1])
    np.testing.assert_allclose(got[2:], want[2:], rtol=4 * 2 ** -23)


def test_seed_range_checked():
    with pytest.raises(ValueError):
        jr.PRNGKey(2 ** 31)
