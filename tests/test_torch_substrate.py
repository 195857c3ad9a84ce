"""The port's substrate helpers against the reference's: the learning-rate
schedules, the numpy data loader and partitions, and the tree arithmetic
helpers; the twins of ``tests/test_substrate.py``'s schedule, loader and
tree cases.  Schedules within 1 ulp of fp32 (the cosine may round apart);
the loader and partitions equal; tree helpers bitwise, ``tree_dot`` and
``tree_l2_norm`` within 1e-6 relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data import loader as jloader, partition as jpartition  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch.data import loader, partition  # noqa: E402
from repro_torch.optim import schedules, warmup_cosine  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine_decay": lambda m: m.cosine_decay(1.0, total_steps=100),
    "cosine_decay_final": lambda m: m.cosine_decay(2e-3, total_steps=37, final_frac=0.0),
    "warmup_cosine": lambda m: m.warmup_cosine(1.0, warmup_steps=10, total_steps=100),
    "warmup_cosine_zero_warmup": lambda m: m.warmup_cosine(5e-4, warmup_steps=0,
                                                           total_steps=50, final_frac=0.2),
}
STEPS = [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_the_reference(name):
    jf, tf = SCHEDULES[name](jschedules), SCHEDULES[name](schedules)
    for s in STEPS:
        want = np.float32(jf(jnp.int32(s)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= float(np.spacing(np.float32(abs(want)) + 1e-30)), \
            (s, float(got), float(want))


def test_warmup_cosine_schedule_shape():
    f = warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    assert float(f(torch.tensor(0))) == pytest.approx(0.0)
    assert float(f(torch.tensor(10))) == pytest.approx(1.0, abs=0.05)
    assert float(f(torch.tensor(100))) < 0.2


@pytest.mark.parametrize("n,test_frac,seed", [(100, 0.2, 0), (37, 0.3, 5), (10, 0.0, 1)])
def test_train_test_split_matches_the_reference(n, test_frac, seed):
    x = np.arange(n * 3).reshape(n, 3)
    y = np.arange(n)
    got = loader.train_test_split(x, y, test_frac, seed)
    want = jloader.train_test_split(x, y, test_frac, seed)
    for g, w in zip(np.concatenate([np.ravel(a) for p in got for a in p]),
                    np.concatenate([np.ravel(a) for p in want for a in p])):
        assert g == w


@pytest.mark.parametrize("n,bs,drop", [(50, 8, True), (50, 8, False), (5, 8, False),
                                       (5, 8, True), (16, 4, True)])
def test_batch_iterator_matches_the_reference(n, bs, drop):
    x = np.arange(n * 2).reshape(n, 2)
    y = np.arange(n)
    got = list(loader.batch_iterator(x, y, bs, seed=3, drop_remainder=drop))
    want = list(jloader.batch_iterator(x, y, bs, seed=3, drop_remainder=drop))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("n,bs", [(0, 4), (3, 4), (8, 4), (9, 4), (17, 5)])
def test_pad_to_batch_matches_the_reference(n, bs):
    """Equal arrays, the reference's quirks included: a shard longer than
    the batch comes back unpadded (one repeat), an empty one empty."""
    x = np.arange(n * 2).reshape(n, 2)
    y = np.arange(n)
    gx, gy = loader.pad_to_batch(x, y, bs)
    wx, wy = jloader.pad_to_batch(x, y, bs)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


def test_iid_partition_and_stats_match_the_reference():
    y = np.random.default_rng(0).integers(0, 6, 3000)
    got, want = partition.iid_partition(len(y), 6, seed=1), jpartition.iid_partition(len(y), 6, seed=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gh, gtv = partition.partition_stats(y, got)
    wh, wtv = jpartition.partition_stats(y, want)
    np.testing.assert_array_equal(gh, wh)
    assert gtv == wtv
    d_parts = partition.dirichlet_partition(y, 6, alpha=0.3, seed=1)
    assert partition.partition_stats(y, d_parts)[1] > gtv * 2


def _trees(seed):
    r = np.random.default_rng(seed)
    a = {"w": r.normal(size=(3, 4)).astype(np.float32),
         "b": {"c": r.normal(size=(5,)).astype(np.float32), "d": np.float32(r.normal())}}
    b = {"w": r.normal(size=(3, 4)).astype(np.float32),
         "b": {"c": r.normal(size=(5,)).astype(np.float32), "d": np.float32(r.normal())}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.tensor(v) for k, v in t.items()}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return (to_t(a), to_t(b)), (to_j(a), to_j(b))


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    return [np.asarray(t)]


@pytest.mark.parametrize("op", ["tree_add", "tree_sub", "tree_scale", "tree_zeros_like",
                                "tree_cast"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_arithmetic_matches_the_reference_bitwise(op, seed):
    (ta, tb), (ja, jb) = _trees(seed)
    args = {"tree_add": ((ta, tb), (ja, jb)), "tree_sub": ((ta, tb), (ja, jb)),
            "tree_scale": ((ta, 0.37), (ja, 0.37)), "tree_zeros_like": ((ta,), (ja,)),
            "tree_cast": ((ta, torch.bfloat16), (ja, jnp.bfloat16))}[op]
    got, want = getattr(tree, op)(*args[0]), getattr(jtree, op)(*args[1])
    for g, w in zip(_leaves(tree.tree_map(lambda x: x.float(), got)),
                    _leaves(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), want))):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_dot_and_norm_match_the_reference(seed):
    (ta, tb), (ja, jb) = _trees(seed)
    got, want = tree.tree_dot(ta, tb), jtree.tree_dot(ja, jb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(tree.tree_l2_norm(ta)), float(jtree.tree_l2_norm(ja)),
                               rtol=1e-6)
