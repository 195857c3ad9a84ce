"""The port's int8 wire tier against the JAX package on the CPU: the
quantize/dequantize twins against the Pallas kernels in interpret mode
(codes and scales bit-equal), the fused q8 eq. 14 twin against
``fedavg_batched_q8_pallas``, and the wire-format byte counts."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.kernels.fedavg.kernel import fedavg_batched_q8_pallas  # noqa: E402
from repro.kernels.quantize import ops as jops  # noqa: E402
from repro.kernels.quantize.kernel import (dequantize_pallas,  # noqa: E402
                                           quantize_batched_pallas, quantize_pallas)
from repro_torch.core import energy  # noqa: E402
from repro_torch.kernels.fedavg.ops import fedavg_flat_batched_q8  # noqa: E402
from repro_torch.kernels.quantize import ops  # noqa: E402
from repro_torch.kernels.quantize.ref import dequantize_ref  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_batched_ref as quantize_ref  # noqa: E402

# the fused mean sums in another order than XLA's einsum: fp32 rounding only
Q8_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _vectors():
    """(name, (L,) fp32): off-tile, a zero tile, exact half-way codes."""
    rng = np.random.default_rng(0)
    zero_tile = rng.standard_normal(3000).astype(np.float32)
    zero_tile[1024:2048] = 0.0
    half = np.zeros(2048, np.float32)
    half[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]        # scale 1: x/s = k + 0.5
    half[1024:1030] = [-127.0, 126.5, -126.5, 3.5, 4.5, -3.5]
    return {"off-tile": rng.standard_normal(1000 + 7).astype(np.float32) * 3.0,
            "P=229": rng.standard_normal(229).astype(np.float32),
            "zero tile": zero_tile, "half-way": half,
            "tiny": rng.standard_normal(2048).astype(np.float32) * 1e-20}


@pytest.mark.parametrize("name", list(_vectors()))
def test_quantize_twin_matches_pallas_bit_for_bit(name):
    x = _vectors()[name]
    jq, js = quantize_pallas(jnp.asarray(x), interpret=True)
    q, s = quantize_ref(_t(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    qc, sc, n = ops.compress_update(_t(x))
    assert torch.equal(qc, q) and torch.equal(sc, s) and n == len(x)
    want = np.asarray(dequantize_pallas(jq, js, len(x), interpret=True))
    assert np.array_equal(dequantize_ref(q, s, len(x)).numpy(), want)
    assert np.array_equal(ops.decompress_update(q, s, len(x)).numpy(), want)


def test_scale_is_the_compiled_reciprocal_multiply():
    """XLA compiles ``absmax / 127`` as ``absmax * fp32(1/127)``; on these
    tiles the exact quotient differs by one ulp, and the twin follows the
    compiled reference."""
    x = np.random.default_rng(2 * 19456).standard_normal(19456).astype(np.float32) * 3.0
    absmax = np.abs(x.reshape(-1, 1024)).max(axis=1)
    _, js = quantize_pallas(jnp.asarray(x), interpret=True)
    _, s = quantize_ref(_t(x))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(s.numpy(), absmax * np.float32(1.0 / 127.0))


def test_half_way_codes_round_to_even():
    q, s = quantize_ref(_t(_vectors()["half-way"]))
    assert s.tolist() == [1.0, 1.0]
    assert q[:6].tolist() == [127, 0, 2, 2, 0, -2]
    assert q[1024:1030].tolist() == [-127, 126, -126, 4, 4, -4]


@pytest.mark.parametrize("b,lp", [(5, 2048), (3, 1024), (2, 19456)])
def test_batched_quantize_twin_matches_pallas_and_single_rows(b, lp):
    rng = np.random.default_rng(b * lp)
    x = (rng.standard_normal((b, lp)) * rng.uniform(0.01, 10.0, (b, 1))).astype(np.float32)
    x[0, :1024] = 0.0                                    # an all-zero tile
    jq, js = quantize_batched_pallas(jnp.asarray(x), interpret=True)
    q, s = ops.quantize_flat_batched(_t(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    for i in range(b):
        qi, si = quantize_ref(_t(x[i]))
        assert torch.equal(q[i], qi) and torch.equal(s[i], si)
    assert np.array_equal(ops.dequantize_flat_batched(q, s).numpy(),
                          np.asarray(jops.dequantize_flat_batched(jq, js)))


def test_batched_quantize_of_a_ragged_row_equals_the_padded_row():
    x = np.random.default_rng(1).standard_normal((2, 1500)).astype(np.float32)
    padded = np.pad(x, ((0, 0), (0, 548)))
    q, s = ops.quantize_flat_batched(_t(x))
    qp, sp = quantize_ref(_t(padded))
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("r,n,lp,zero_row", [(3, 4, 2048, 1), (2, 5, 19456, None),
                                             (1, 1, 1024, None)]
                         + [(2, n, 2048, 1) for n in range(1, 18)])
def test_q8_fedavg_twin_matches_pallas(r, n, lp, zero_row):
    """At the fleet's Lp and edge shapes, and at every N from 1 to 17 (the
    CUDA kernel's 16 instantiations and its any-N form are held to this
    twin on the card)."""
    rng = np.random.default_rng(r + n + lp)
    q, s = quantize_ref(_t(rng.standard_normal((r * n, lp)).astype(np.float32)))
    q, s = q.reshape(r, n, lp), s.reshape(r, n, -1)
    w = (rng.random((r, n)) + 0.1).astype(np.float32)
    if zero_row is not None:
        w[zero_row] = 0.0
    want = np.asarray(fedavg_batched_q8_pallas(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                               jnp.asarray(w), interpret=True))
    got = fedavg_flat_batched_q8(q, s, _t(w)).numpy()
    np.testing.assert_allclose(got, want, **Q8_TOL)
    if zero_row is not None:
        assert np.all(got[zero_row] == 0.0)


@pytest.mark.parametrize("p", [229, 1024, 2821, 18566])
def test_wire_sizes_and_auto_resolution_match_reference(p):
    assert ops.TILE == jops.TILE
    assert ops.AUTO_COMPRESS_MAX_RATIO == jops.AUTO_COMPRESS_MAX_RATIO
    assert ops.padded_len(p) == jops.padded_len(p)
    assert ops.compressed_nbytes(p) == jops.compressed_nbytes(p)
    for mode in (None, "int8", "auto"):
        assert ops.resolve_compress(mode, p) == jops.resolve_compress(mode, p)
        for enc, raw in ((True, None), (False, 4 * p), (False, None)):
            assert energy.update_wire_bytes(p, encrypt=enc, compress=mode, raw_bytes=raw) \
                == jenergy.update_wire_bytes(p, encrypt=enc, compress=mode, raw_bytes=raw)
    with pytest.raises(ValueError, match="compress"):
        ops.resolve_compress("int4", p)
