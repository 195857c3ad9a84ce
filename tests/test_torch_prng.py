"""repro_torch.core.prng against jax.random, bit for bit, under both values
of ``jax_threefry_partitionable``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


SEEDS = [0, 1, 3, 17, 12345, 2 ** 31 - 1]
DATA = [0, 1, 2, 7, 1000, 2 ** 31, 2 ** 32 - 1]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed, threefry_mode):
    assert np.array_equal(_np(jax.random.PRNGKey(seed)), prng.prng_key(seed).numpy())


def test_prng_key_rejects_seeds_beyond_int32():
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, threefry_mode):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    for d in DATA:
        want = _np(jax.random.fold_in(key, jnp.uint32(d)))
        assert np.array_equal(want, prng.fold_in(tkey, d).numpy()), d


def test_fold_in_vectorized_matches_scalar(threefry_mode):
    tkey = prng.prng_key(5)
    batch = prng.fold_in(tkey, torch.tensor(DATA, dtype=torch.int64))
    for i, d in enumerate(DATA):
        assert torch.equal(batch[i], prng.fold_in(tkey, d))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_matches_jax(seed, threefry_mode):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    for d in DATA:
        fk = jax.random.fold_in(key, jnp.uint32(d))
        want = int(jax.random.bits(fk, (), jnp.uint32))
        got = int(prng.bits(prng.fold_in(tkey, d), partitionable=threefry_mode))
        assert want == got, (seed, d)


def test_bits_modes_differ():
    """The two modes are genuinely different streams, so the flag matters."""
    k = prng.fold_in(prng.prng_key(3), 1)
    assert int(prng.bits(k, partitionable=True)) != int(prng.bits(k, partitionable=False))


# ---------------------------------------------------------------------------
# split, shaped bits, randint, uniform, normal (the adversary's draws)
# ---------------------------------------------------------------------------

SHAPES = [(), (1,), (5,), (6,), (2, 3), (1025,)]


def _key(seed, d=3):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(d)),
            prng.fold_in(prng.prng_key(seed), d))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_split_matches_jax(num, seed, threefry_mode):
    k, tk = _key(seed)
    want = _np(jax.random.split(k, num))
    assert np.array_equal(prng.split(tk, num, partitionable=threefry_mode).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_shaped_bits_match_jax(shape, threefry_mode):
    for seed in (0, 7):
        k, tk = _key(seed)
        want = _np(jax.random.bits(k, shape, jnp.uint32))
        got = prng.random_bits(tk, shape, partitionable=threefry_mode)
        assert got.shape == shape
        assert np.array_equal(got.numpy(), want)


def test_scalar_random_bits_equal_bits(threefry_mode):
    tk = prng.fold_in(prng.prng_key(1), torch.arange(8))
    assert torch.equal(prng.random_bits(tk, (), partitionable=threefry_mode),
                       prng.bits(tk, partitionable=threefry_mode))


@pytest.mark.parametrize("lo,hi", [(-127, 128), (0, 2 ** 31 - 1), (3, 10), (5, 5),
                                   (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(), (7,), (2, 1024)])
def test_randint_matches_jax(lo, hi, shape, threefry_mode):
    for seed in (0, 12345):
        k, tk = _key(seed)
        want = _np(jax.random.randint(k, shape, lo, hi, jnp.int32))
        got = prng.randint(tk, shape, lo, hi, partitionable=threefry_mode)
        assert np.array_equal(got.numpy(), want), (seed, lo, hi)


def test_randint_over_a_batch_of_keys_matches_per_key_draws(threefry_mode):
    keys = prng.fold_in(prng.prng_key(1), torch.arange(4))
    batch = prng.randint(keys[None], (9,), -127, 128, partitionable=threefry_mode)
    for i in range(4):
        k = jax.random.fold_in(jax.random.PRNGKey(1), jnp.uint32(i))
        assert np.array_equal(batch[0, i].numpy(),
                              _np(jax.random.randint(k, (9,), -127, 128, jnp.int32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bits_match_jax(shape, threefry_mode):
    k, tk = _key(17)
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    got = prng.uniform(tk, shape, partitionable=threefry_mode).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, 1.0))
    got = prng.uniform(tk, shape, float(lo), 1.0, partitionable=threefry_mode).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_matches_jax(shape, threefry_mode):
    """torch.erfinv and XLA's erf_inv differ by a few ulps in the tails."""
    for seed in (0, 7):
        k, tk = _key(seed)
        want = np.asarray(jax.random.normal(k, shape, jnp.float32))
        got = prng.normal(tk, shape, partitionable=threefry_mode).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
