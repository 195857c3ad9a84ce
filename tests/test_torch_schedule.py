"""repro_torch.core.schedule against repro.core.schedule: idx and w
bit-equal under both threefry modes, including shards smaller than a
batch."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import schedule as jschedule  # noqa: E402
from repro_torch.core import prng, schedule  # noqa: E402


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("seed,epochs,n,batch", [
    (3, 2, 100, 32),     # drop-last full batches
    (0, 1, 10, 32),      # n < batch: one padded step
    (5, 3, 64, 32),      # n a multiple of the batch
    (7, 2, 33, 8),
    (11, 2, 32, 32),     # n == batch
    (2, 1, 1, 4),        # a single sample
])
def test_minibatch_plan_bit_equal(seed, epochs, n, batch, threefry_mode):
    idx, w = jschedule.minibatch_plan(seed, epochs=epochs, n=n, batch=batch)
    tidx, tw = schedule.minibatch_plan(seed, epochs=epochs, n=n, batch=batch,
                                       partitionable=threefry_mode)
    assert np.array_equal(np.asarray(idx), tidx.numpy())
    assert np.array_equal(np.asarray(w), tw.numpy())
    assert tuple(tidx.shape) == (epochs, schedule.fit_steps(n, batch), batch)


def test_plans_differ_between_modes():
    a, _ = schedule.minibatch_plan(3, epochs=2, n=100, batch=32, partitionable=True)
    b, _ = schedule.minibatch_plan(3, epochs=2, n=100, batch=32, partitionable=False)
    assert not torch.equal(a, b)


def test_index_scores_prefix_stable_and_equal_to_jax(threefry_mode):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jschedule.index_scores(key, 50)).astype(np.int64)
    got = schedule.index_scores(prng.prng_key(9), 50, partitionable=threefry_mode)
    assert np.array_equal(want, got.numpy())
    longer = schedule.index_scores(prng.prng_key(9), 80, partitionable=threefry_mode)
    assert torch.equal(longer[:50], got)


def test_padded_plan_equals_jax(threefry_mode):
    """plan_from_scores over a padded shard (n < n_pad): the sentinel sorts
    the padding last, exactly as the reference."""
    scores = jschedule.epoch_scores(4, 2, 48)
    idx, w = jschedule.plan_from_scores(scores, 37, 8, 5)
    tscores = schedule.epoch_scores(4, 2, 48, partitionable=threefry_mode)
    assert np.array_equal(np.asarray(scores).astype(np.int64), tscores.numpy())
    tidx, tw = schedule.plan_from_scores(tscores, 37, 8, 5)
    assert np.array_equal(np.asarray(idx), tidx.numpy())
    assert np.array_equal(np.asarray(w), tw.numpy())


@pytest.mark.parametrize("n,batch,steps", [(10, 32, 1), (100, 32, 3), (64, 32, 2)])
def test_fit_steps_matches_reference(n, batch, steps):
    assert schedule.fit_steps(n, batch) == jschedule.fit_steps(n, batch) == steps
