"""The robust statistics of the port (``repro_torch.kernels.robust``)
against the JAX package on the CPU: the plain twins against the Pallas
kernels (interpret mode) and the jnp oracles at the reference's shapes,
the hand-checkable cases of ``tests/test_robust_kernels.py``, the q8
twins against dense on the dequantized buffer, and the non-kernel ops
(``clip_factors``, ``robust_aggregate[_q8]``) against the JAX ops.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.robust import kernel as jkernel  # noqa: E402
from repro.kernels.robust import ops as jops  # noqa: E402
from repro.kernels.robust import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.quantize.ref import (dequantize_batched_ref,  # noqa: E402
                                              quantize_batched_ref)
from repro_torch.kernels.robust import kernel as tkernel  # noqa: E402
from repro_torch.kernels.robust import ops as tops  # noqa: E402
from repro_torch.kernels.robust import ref as tref  # noqa: E402

SHAPES = [(1, 3, 17), (4, 5, 2048), (8, 4, 3001), (16, 6, 777)]
# sums over N in another order than XLA's: fp32 rounding only (the
# reference's own Pallas-vs-oracle tolerance)
TOL = dict(rtol=1e-5, atol=1e-5)


def _world(r, n, l, seed=17):
    rng = np.random.default_rng(seed + r * 100 + n)
    u = rng.normal(size=(r, n, l)).astype(np.float32)
    w = ((rng.random((r, n)) > 0.3) * rng.random((r, n))).astype(np.float32)
    return u, w


def _q8_world(r, n, lp, seed=17):
    rng = np.random.default_rng(seed + lp)
    q, s = quantize_batched_ref(torch.from_numpy(
        rng.normal(size=(r * n, lp)).astype(np.float32)))
    w = ((rng.random((r, n)) > 0.3) * rng.random((r, n))).astype(np.float32)
    return q.reshape(r, n, lp), s.reshape(r, n, -1), torch.from_numpy(w)


T = torch.from_numpy

# ---------------------------------------------------------------------------
# twins against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------

_PAIRS = {
    "trimmed_mean": (jkernel.trimmed_mean_batched_pallas, jref.trimmed_mean_batched_ref,
                     tops.trimmed_mean_flat_batched),
    "median": (jkernel.median_batched_pallas, jref.median_batched_ref,
               tops.median_flat_batched),
}


@pytest.mark.parametrize("stat", list(_PAIRS))
@pytest.mark.parametrize("r,n,l", SHAPES)
def test_column_twins_match_pallas_and_oracle(stat, r, n, l):
    pallas, oracle, twin = _PAIRS[stat]
    u, w = _world(r, n, l)
    got = twin(T(u), T(w))
    assert got.shape == (r, l) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas(jnp.asarray(u), jnp.asarray(w),
                                                              interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle(jnp.asarray(u), jnp.asarray(w))),
                               **TOL)


@pytest.mark.parametrize("r,n,l", SHAPES)
def test_sqnorm_twin_matches_pallas_and_oracle(r, n, l):
    u, _ = _world(r, n, l)
    got = tref.sqnorm_batched_ref(T(u))
    assert got.shape == (r, n)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jkernel.sqnorm_batched_pallas(jnp.asarray(u), interpret=True)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tops.l2norm_flat_batched(T(u)).numpy(),
                               np.asarray(jops.l2norm_flat_batched(jnp.asarray(u),
                                                                   use_pallas=False)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r,n,lp", [(2, 3, 1024), (4, 5, 2048), (3, 6, 3072)])
def test_q8_twins_match_pallas_q8(r, n, lp):
    q, s, w = _q8_world(r, n, lp)
    jq, js, jw = (jnp.asarray(t.numpy()) for t in (q, s, w))
    for twin, pallas in ((tops.trimmed_mean_flat_batched_q8,
                          jkernel.trimmed_mean_batched_q8_pallas),
                         (tops.median_flat_batched_q8, jkernel.median_batched_q8_pallas)):
        np.testing.assert_allclose(twin(q, s, w).numpy(),
                                   np.asarray(pallas(jq, js, jw, interpret=True)), **TOL)
    np.testing.assert_allclose(
        tref.sqnorm_batched_q8_ref(q, s).numpy(),
        np.asarray(jkernel.sqnorm_batched_q8_pallas(jq, js, interpret=True)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# statistic semantics (hand-checkable cases of tests/test_robust_kernels.py)
# ---------------------------------------------------------------------------


def _col(values, weights):
    u = torch.tensor(values, dtype=torch.float32)[None, :, None]
    return u, torch.tensor([weights], dtype=torch.float32)


def test_trimmed_mean_drops_extremes():
    u, w = _col([1.0, 100.0, 3.0, -50.0, 2.0], [1.0] * 5)
    assert tops.trimmed_mean_flat_batched(u, w).tolist() == [[2.0]]


def test_trimmed_mean_tie_breaks_first_instance():
    # two equal maxima: only the first drops, then the 0: mean(5, 1) = 3
    u, w = _col([5.0, 5.0, 0.0, 1.0], [1.0] * 4)
    assert tops.trimmed_mean_flat_batched(u, w).tolist() == [[3.0]]
    # the weights tell which instance dropped: the first 5 (weight 1) goes,
    # the second (weight 3) stays with the 1 (weight 1): (15 + 1) / 4
    u, w = _col([5.0, 5.0, 0.0, 1.0], [1.0, 3.0, 1.0, 1.0])
    assert tops.trimmed_mean_flat_batched(u, w).tolist() == [[4.0]]


def test_trimmed_mean_min_tie_and_inactive_extremes():
    # ties at the minimum: the first -2 drops; inactive 99 and -99 never count
    u, w = _col([-2.0, 99.0, -2.0, 4.0, -99.0, 6.0], [2.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    # active: -2 (w2), -2 (w1), 4 (w1), 6 (w1); drop 6, then the first -2
    assert tops.trimmed_mean_flat_batched(u, w).tolist() == [[1.0]]


def test_trimmed_mean_small_active_falls_back_to_mean():
    u, w = _col([1.0, 3.0, 99.0], [1.0, 3.0, 0.0])
    assert tops.trimmed_mean_flat_batched(u, w).tolist() == [[2.5]]
    assert tops.trimmed_mean_flat_batched(u, torch.zeros(1, 3)).tolist() == [[0.0]]


def test_median_weights_gate_activity_only():
    u, w = _col([1.0, 9.0, 4.0, 777.0], [0.1, 5.0, 2.0, 0.0])
    assert tops.median_flat_batched(u, w).tolist() == [[4.0]]
    assert tops.median_flat_batched(u, torch.ones(1, 4)).tolist() == [[6.5]]
    assert tops.median_flat_batched(u, torch.zeros(1, 4)).tolist() == [[0.0]]


@pytest.mark.parametrize("n", [1, 2, 3, 6, 16])
def test_column_twins_at_every_active_count(n):
    """N = 1 .. 16 with every number of active contributors, against the
    jnp oracles: the (m - 1) // 2 and m // 2 ranks, the <= 2 fallback."""
    rng = np.random.default_rng(n)
    u = rng.normal(size=(n + 1, n, 33)).astype(np.float32)
    w = np.zeros((n + 1, n), np.float32)
    for m in range(n + 1):
        w[m, rng.permutation(n)[:m]] = rng.random(m).astype(np.float32) + 0.1
    for stat, (_, oracle, twin) in _PAIRS.items():
        np.testing.assert_allclose(twin(T(u), T(w)).numpy(),
                                   np.asarray(oracle(jnp.asarray(u), jnp.asarray(w))),
                                   **TOL, err_msg=stat)


# ---------------------------------------------------------------------------
# q8 twins against dense on the dequantized buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,n,lp", [(2, 3, 1024), (4, 5, 2048), (8, 4, 3072), (2, 6, 19456)])
def test_q8_twins_equal_dense_on_dequantized(r, n, lp):
    q, s, w = _q8_world(r, n, lp)
    dense = dequantize_batched_ref(q, s)
    for fused, plain in ((tops.trimmed_mean_flat_batched_q8, tops.trimmed_mean_flat_batched),
                         (tops.median_flat_batched_q8, tops.median_flat_batched)):
        assert torch.equal(fused(q, s, w), plain(dense, w))
    torch.testing.assert_close(tops.l2norm_flat_batched_q8(q, s),
                               tops.l2norm_flat_batched(dense), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the non-kernel ops against the JAX ops
# ---------------------------------------------------------------------------


def test_clip_factors_median_threshold():
    c, clipped, tau = tops.clip_factors(torch.tensor([[1.0, 2.0, 10.0]]), torch.ones(1, 3))
    assert tau.tolist() == [2.0]
    torch.testing.assert_close(c, torch.tensor([[1.0, 1.0, 0.2]]))
    assert clipped.tolist() == [[False, False, True]]
    # inactive slots: factor 1, never flagged, even with a huge norm
    c0, clipped0, _ = tops.clip_factors(torch.tensor([[1.0, 2.0, 10.0]]),
                                        torch.tensor([[1.0, 1.0, 0.0]]))
    assert float(c0[0, 2]) == 1.0 and not bool(clipped0[0, 2])
    # an empty row: tau = inf, nothing clips
    ce, cle, te = tops.clip_factors(torch.tensor([[3.0, 4.0]]), torch.zeros(1, 2))
    assert te.tolist() == [float("inf")] and ce.tolist() == [[1.0, 1.0]]
    assert not cle.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_factors_match_jax(seed):
    rng = np.random.default_rng(seed)
    norms = (rng.random((6, 9)) * 10).astype(np.float32)
    norms[0, 3] = 0.0                                   # a zero update
    w = ((rng.random((6, 9)) > 0.3) * rng.random((6, 9))).astype(np.float32)
    w[5] = 0.0                                          # an all-zero weight row
    c, clipped, tau = tops.clip_factors(T(norms), T(w))
    jc, jclipped, jtau = jops.clip_factors(jnp.asarray(norms), jnp.asarray(w))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert np.array_equal(clipped.numpy(), np.asarray(jclipped))
    assert np.array_equal(tau.numpy(), np.asarray(jtau))
    assert int(clipped.sum(dim=1).max()) <= 4           # at most half the active set


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "clip"])
@pytest.mark.parametrize("r,n,l", [(4, 5, 777), (3, 6, 2048 + 3)])
def test_robust_aggregate_matches_jax(method, r, n, l):
    u, w = _world(r, n, l, seed=3)
    u[0, 1] *= 50.0                                     # an outlier that clips
    agg, clipped = tops.robust_aggregate(T(u), T(w), method=method)
    jagg, jclipped = jops.robust_aggregate(jnp.asarray(u), jnp.asarray(w), method=method)
    assert agg.shape == (r, l) and clipped.shape == (r, n)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), **TOL)
    assert np.array_equal(clipped.numpy(), np.asarray(jclipped))
    if method != "clip":
        assert not clipped.any()


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "clip"])
def test_robust_aggregate_q8_matches_jax_and_dense(method):
    q, s, w = _q8_world(3, 4, 2048)
    q[1, 2] = torch.clamp(q[1, 2].to(torch.int32) * 3, -127, 127).to(torch.int8)
    s[1, 2] *= 40.0
    agg, clipped = tops.robust_aggregate_q8(q, s, w, method=method)
    jagg, jclipped = jops.robust_aggregate_q8(*(jnp.asarray(t.numpy()) for t in (q, s, w)),
                                              method=method)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-5, atol=1e-6)
    assert np.array_equal(clipped.numpy(), np.asarray(jclipped))
    dagg, dclipped = tops.robust_aggregate(dequantize_batched_ref(q, s), w, method=method)
    assert torch.equal(clipped, dclipped)
    torch.testing.assert_close(agg, dagg, rtol=1e-6, atol=1e-7)


def test_robust_aggregate_rejects_an_unknown_method():
    u, w = _world(1, 3, 17)
    for fn, args in ((tops.robust_aggregate, (T(u), T(w))),
                     (tops.robust_aggregate_q8, _q8_world(1, 3, 1024))):
        with pytest.raises(ValueError, match="robust method"):
            fn(*args, method="krum")


def test_clip_recovers_from_scale_attack():
    """One 100x-scaled contributor drags plain fedavg but barely moves the
    robust aggregates."""
    from repro_torch.kernels.fedavg.ops import fedavg_flat_batched

    honest = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 5, 256))
                              .astype(np.float32))
    attacked = honest.clone()
    attacked[0, 2] *= 100.0
    w = torch.ones(1, 5)
    clean = fedavg_flat_batched(honest, w)
    naive = fedavg_flat_batched(attacked, w)
    assert float((naive - clean).norm()) > 10 * float(clean.norm())
    for method in ("clip", "trimmed_mean", "median"):
        rob = tops.robust_aggregate(attacked, w, method=method)[0]
        assert float((rob - clean).norm()) < 0.5 * float((naive - clean).norm()), method


def test_cpu_dispatch_runs_the_twins_without_launching():
    kernels.reset_launch_counts()
    u, w = _world(2, 3, 1000)
    q, s, wq = _q8_world(2, 3, 1024)
    for method in ("trimmed_mean", "median", "clip"):
        tops.robust_aggregate(T(u), T(w), method=method)
        tops.robust_aggregate_q8(q, s, wq, method=method)
    counts = kernels.launch_counts()
    assert {"trimmed_mean", "trimmed_mean_q8", "median", "median_q8", "sqnorm",
            "sqnorm_q8"} <= set(counts)
    assert not any(counts.values())


def test_robust_kernel_wrappers_reject_cpu_tensors():
    u, w = torch.zeros(1, 3, 8), torch.ones(1, 3)
    q, s = torch.zeros(1, 3, 1024, dtype=torch.int8), torch.ones(1, 3, 1)
    for call in (lambda: tkernel.trimmed_mean_cuda(u, w), lambda: tkernel.median_cuda(u, w),
                 lambda: tkernel.sqnorm_cuda(u), lambda: tkernel.trimmed_mean_q8_cuda(q, s, w),
                 lambda: tkernel.median_q8_cuda(q, s, w), lambda: tkernel.sqnorm_q8_cuda(q, s)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="Lp % 1024"):
        tkernel.sqnorm_q8_cuda(torch.zeros(1, 3, 1000, dtype=torch.int8), s)
