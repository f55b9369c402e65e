"""The port's threefry (paddle_tpu_torch.core.threefry) against
``jax.random`` with ``jax_threefry_partitionable`` on.

PRNGKey, fold_in, the raw bits and the float32 uniforms are BIT-equal for
64 (seed, position) pairs at V in {1, 7, 256, 50257}, drawn as the
sampler draws them: one [64, V] call. The Gumbel draw is not bit-equal:
both packages compute ``-log(-log(u))`` from the same uniform, but torch's
float32 ``log`` and XLA's CPU ``log`` differ by up to 1 ulp (each of the
two logs is held to 1 ulp here), which moves a Gumbel value by at most
``2 ulp(|g|) + 2**-22`` (held below; about 5e-7 at |g| ~ 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import threefry as tf

VOCABS = [1, 7, 256, 50257]
TINY = float(np.finfo(np.float32).tiny)


def pairs():
    rng = np.random.RandomState(17)
    seeds = rng.randint(0, 2 ** 31 - 1, 64).astype(np.int32)
    pos = rng.randint(0, 1024, 64).astype(np.int32)
    seeds[:4] = [0, 1, 2 ** 31 - 1, 1000]
    pos[:4] = [0, 1023, 5, 0]
    return seeds, pos


_JAX = {}


def jax_draws(v):
    """jax.random's keys, bits, uniforms and Gumbels for the 64 pairs."""
    if v not in _JAX:
        seeds, pos = pairs()
        keys = jax.vmap(lambda s, p: jax.random.fold_in(
            jax.random.PRNGKey(s), p))(seeds, pos)
        _JAX[v] = tuple(np.asarray(x) for x in (
            keys,
            jax.vmap(lambda k: jax.random.bits(k, (v,), jnp.uint32))(keys),
            jax.vmap(lambda k: jax.random.uniform(k, (v,),
                                                  jnp.float32))(keys),
            jax.vmap(lambda k: jax.random.uniform(
                k, (v,), jnp.float32, TINY, 1.0))(keys),
            jax.vmap(lambda k: jax.random.gumbel(k, (v,),
                                                 jnp.float32))(keys)))
    return _JAX[v]


def port_key():
    seeds, pos = pairs()
    return tf.fold_in(tf.prng_key(torch.as_tensor(seeds)),
                      torch.as_tensor(pos))


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_threefry2x32_known_answers():
    """Random123's threefry2x32_20 answers, which jax's threefry_2x32
    gives too."""
    zero = torch.zeros((), dtype=torch.int64)
    assert [int(x) for x in tf.threefry2x32(zero, zero, zero, zero)] == \
        [0x6b200159, 0x99ba4efe]
    ones = torch.full((), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(x) for x in tf.threefry2x32(ones, ones, ones, ones)] == \
        [0x1cb996fc, 0xbb002be7]


@pytest.mark.parametrize("seed", [0, 7, 1000, 2 ** 31 - 1, -1])
def test_prng_key_and_fold_in_equal_jax(seed):
    key = tf.prng_key(seed)
    want = np.asarray(jax.random.PRNGKey(seed))
    assert (tf.key_words(key) == want).all()
    for data in (0, 3, 1023):
        got = tf.key_words(tf.fold_in(key, data))
        assert (got == np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(seed), data))).all()
    # the value quoted in the port's design notes
    assert tf.key_words(tf.fold_in(tf.prng_key(7), 3)).tolist() == \
        [276534068, 1641862660]


@pytest.mark.parametrize("v", VOCABS)
def test_bits_and_uniform_bit_equal_to_jax(v):
    keys, bits, uni, uni_tiny, _ = jax_draws(v)
    key = port_key()
    assert (tf.key_words(key) == keys).all()
    got_bits = tf.random_bits(key, v)
    assert got_bits.shape == (64, v) and got_bits.dtype == torch.int64
    assert (got_bits.numpy().astype(np.uint32) == bits).all()
    got = tf.uniform(key, v).numpy()
    assert got.dtype == np.float32
    assert (got.view(np.int32) == uni.view(np.int32)).all()
    got = tf.uniform(key, v, TINY, 1.0).numpy()
    assert (got.view(np.int32) == uni_tiny.view(np.int32)).all()


@pytest.mark.parametrize("v", VOCABS)
def test_gumbel_within_a_log_ulp_of_jax(v):
    _, _, _, u, g_jax = jax_draws(v)
    # each log within 1 ulp of XLA's on the same input
    inner_t = torch.log(torch.tensor(u)).numpy()
    inner_j = np.asarray(jnp.log(u))
    assert ulps(inner_t, inner_j).max() <= 1
    outer_t = torch.log(-torch.tensor(inner_j)).numpy()
    assert ulps(outer_t, np.asarray(jnp.log(-inner_j))).max() <= 1
    g = tf.gumbel(port_key(), v).numpy()
    assert g.shape == (64, v) and np.isfinite(g).all()
    err = np.abs(g.astype(np.float64) - g_jax)
    bound = 2 * np.spacing(np.abs(g_jax)) + 2.0 ** -22
    assert (err <= bound).all(), float((err / bound).max())


def test_draws_differ_by_seed_and_position():
    a = tf.random_bits(tf.fold_in(tf.prng_key(5), 10), 64)
    b = tf.random_bits(tf.fold_in(tf.prng_key(5), 11), 64)
    c = tf.random_bits(tf.fold_in(tf.prng_key(6), 10), 64)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    u = tf.uniform(tf.fold_in(tf.prng_key(5), 10), 4096)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
