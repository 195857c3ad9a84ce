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
