"""JAX's threefry stream in torch integer ops (`aclswarm_torch.core.prng`)
against `jax.random` on the same keys, JAX 0.9.0 on the CPU with x64 on
(`tests/conftest.py`) and its default partitionable threefry.

- threefry2x32 (`jax._src.prng.threefry_2x32`), fold_in and the 32- and
  64-bit random bits at shapes (), (7,), (5, 3) and (1000,), and uniforms
  in float32 and float64: bit for bit, on fixed keys and on keys drawn by
  hypothesis (float64 uniforms over ranges whose width is a power of two,
  as all of the reference's are; see `prng.uniform`).
- Normals: XLA's own erf_inv polynomials and log1p form, but XLA's log
  and its fused multiply-adds in float64 are not reproduced, so a draw
  may differ from JAX's by a few ulp. Measured on 200,000 draws of three
  keys: float32 0.44% of draws differ, by at most 3 ulp; float64 7.6%,
  by at most 4 ulp. Held at 4 ulp (float32) and 8 ulp (float64) of each
  draw's magnitude.
- Port-only: a batch of per-trial keys hashes as the keys one by one,
  and a draw does not depend on where in the tensor it lies (no
  vectorized and scalar paths that round otherwise).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from aclswarm_torch.core import prng

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

SHAPES = [(), (7,), (5, 3), (1000,)]
KEYS = [(0, 0), (0, 42), (3653403231, 2735729615), (0xFFFFFFFF, 1)]
ULP_TOL = {torch.float32: 4, torch.float64: 8}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _keys(words):
    kd = np.asarray(words, np.uint32)
    return (jax.random.wrap_key_data(jnp.asarray(kd)),
            torch.as_tensor(kd.astype(np.int64)))


@pytest.mark.parametrize("words", KEYS)
def test_threefry2x32_and_fold_in(words):
    jk, tk = _keys(words)
    counts = np.random.default_rng(0).integers(0, 2**32, size=9,
                                               dtype=np.uint64)
    counts = counts.astype(np.uint32)
    for c in (counts, counts[:8], counts[:1]):
        want = np.asarray(jprng.threefry_2x32(
            jnp.asarray(np.asarray(words, np.uint32)), jnp.asarray(c)))
        got = prng.threefry_2x32(tk, torch.as_tensor(c.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for data in (0, 1, 17, 2**31 - 1, 123456):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, data)))
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      want.astype(np.int64))
    # a tensor of data, as a batch's per-trial ticks arrive
    got = prng.fold_in(tk, torch.tensor([5], dtype=torch.int32))
    want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, 5)))
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.int64))


@pytest.mark.parametrize("words", KEYS[1:3])
def test_random_bits_32_and_64(words):
    jk, tk = _keys(words)
    for shape in SHAPES:
        want32 = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
        np.testing.assert_array_equal(
            prng.random_bits(tk, 32, shape).numpy(),
            want32.astype(np.int64), err_msg=str(shape))
        want64 = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint64))
        got64 = prng.random_bits(tk, 64, shape).numpy().view(np.uint64)
        np.testing.assert_array_equal(got64, want64, err_msg=str(shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=str)
def test_uniform_bit_for_bit(dtype):
    # a width that is a power of two, as every draw of the reference's;
    # float32 holds any width (its fused scaling is taken exactly)
    ranges = [(0.0, 1.0), (-0.75, 1.25)] + (
        [(-0.75, 2.5)] if dtype == torch.float32 else [])
    for words in KEYS[1:3]:
        jk, tk = _keys(words)
        for shape in SHAPES:
            for lo, hi in ranges:
                want = np.asarray(jax.random.uniform(
                    jk, shape, dtype=JDT[dtype], minval=lo, maxval=hi))
                np.testing.assert_array_equal(
                    prng.uniform(tk, shape, dtype, lo, hi).numpy(), want,
                    err_msg=str((words, shape, lo, hi)))


@settings(max_examples=10, deadline=None)
@given(k0=st.integers(0, 2**32 - 1), k1=st.integers(0, 2**32 - 1),
       data=st.integers(0, 2**31 - 1))
def test_hypothesis_keys_bit_for_bit(k0, k1, data):
    jk, tk = _keys((k0, k1))
    jf, tf = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
    np.testing.assert_array_equal(
        tf.numpy(), np.asarray(jax.random.key_data(jf)).astype(np.int64))
    for w, jdt in ((32, jnp.uint32), (64, jnp.uint64)):
        want = np.asarray(jax.random.bits(jf, (5, 3), dtype=jdt))
        got = prng.random_bits(tf, w, (5, 3)).numpy()
        if w == 64:
            got = got.view(np.uint64)
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    for dtype in (torch.float32, torch.float64):
        np.testing.assert_array_equal(
            prng.uniform(tf, (7,), dtype).numpy(),
            np.asarray(jax.random.uniform(jf, (7,), dtype=JDT[dtype])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=str)
@pytest.mark.parametrize("words", KEYS[1:])
def test_normal_within_ulp(words, dtype):
    jk, tk = _keys(words)
    want = np.asarray(jax.random.normal(jk, (20000,), dtype=JDT[dtype]))
    got = prng.normal(tk, (20000,), dtype).numpy()
    ulp = np.spacing(np.abs(want).astype(want.dtype)).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want) / ulp
    assert err.max() <= ULP_TOL[dtype], err.max()
    # the draws are standard normal
    assert abs(got.mean()) < 0.05 and abs(got.std() - 1.0) < 0.05


def test_batched_keys_equal_lone_keys():
    """(B, 2) keys with (B,) fold-in data hash as B lone calls, and a
    draw does not depend on its place in the tensor (the batch's rows,
    every offset, equal the lone draws bit for bit)."""
    words = np.asarray(KEYS[1:], np.int64)
    keys = torch.as_tensor(words)
    ticks = torch.tensor([3, 11, 29], dtype=torch.int32)
    folded = prng.fold_in(keys, ticks)
    for b in range(len(words)):
        lone = prng.fold_in(keys[b], int(ticks[b]))
        assert torch.equal(folded[b], lone)
        for dtype in (torch.float32, torch.float64):
            for shape in ((6, 3), (5,), (1, 7, 3)):
                assert torch.equal(prng.normal(folded, shape, dtype)[b],
                                   prng.normal(lone, shape, dtype))
                assert torch.equal(prng.uniform(folded, shape, dtype)[b],
                                   prng.uniform(lone, shape, dtype))


def test_erf_inv_edges():
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor([-1.0, 0.0, 1.0], dtype=dtype)
        out = prng.erf_inv(x)
        assert out[0] == -np.inf and out[1] == 0 and out[2] == np.inf
        u = torch.linspace(-0.999, 0.999, 101, dtype=torch.float64)
        np.testing.assert_allclose(
            prng.erf_inv(u.to(dtype)).double().numpy(),
            torch.special.erfinv(u).numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="widths"):
        prng.random_bits(torch.zeros(2, dtype=torch.int64), 16, (3,))
