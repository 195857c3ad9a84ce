"""The port's kernel twins against the JAX Pallas kernels (interpret mode)
and the JAX oracles; the CUDA kernels against their twins on a card.

The comparisons with the JAX package skip where jax is absent, and the
kernel-against-twin cases (marker ``cuda``) skip where there is no CUDA
device; on the card they run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from repro_torch import kernels
from repro_torch.core import crypto
from repro_torch.kernels import _build
from repro_torch.kernels.aes_ctr import ops as aes_ops
from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref, counter_blocks_ref
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda, fedavg_batched_q8_cuda
from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell.kernel import lstm_cell_cuda
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.kernels.quantize.kernel import dequantize_cuda, quantize_cuda
from repro_torch.kernels.quantize.ref import (dequantize_batched_ref, dequantize_ref,
                                              quantize_batched_ref)
from repro_torch.kernels.robust import kernel as robust_kernel
from repro_torch.kernels.robust import ref as robust_ref

# eq. 14 sums in another order than XLA's einsum: fp32 rounding only
FEDAVG_TOL = dict(rtol=1e-6, atol=1e-6)
# the cell's two matmuls + transcendental functions, fp32
LSTM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def ref():
    """The JAX package's kernels and oracles; skips where jax is absent
    (the machine with the card has none)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import crypto as jcrypto
    from repro.kernels.aes_ctr.kernel import aes_ctr_pallas
    from repro.kernels.fedavg.kernel import fedavg_batched_pallas, fedavg_pallas
    from repro.kernels.fedavg.ref import fedavg_ref
    from repro.kernels.lstm_cell.kernel import lstm_cell_pallas
    from repro.kernels.lstm_cell.ref import lstm_cell_ref as jlstm_ref

    return SimpleNamespace(jax=jax, jnp=jnp, jcrypto=jcrypto, aes_ctr_pallas=aes_ctr_pallas,
                           fedavg_batched_pallas=fedavg_batched_pallas,
                           fedavg_pallas=fedavg_pallas, fedavg_ref=fedavg_ref,
                           lstm_cell_pallas=lstm_cell_pallas, jlstm_ref=jlstm_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# eq. 14
# ---------------------------------------------------------------------------

FEDAVG_SHAPES = [(1, 5, 4096), (2, 3, 1000 + 7), (1, 1, 513), (3, 4, 2048 + 1)]


@pytest.mark.parametrize("r,n,l", FEDAVG_SHAPES)
def test_fedavg_ref_matches_pallas_batched(r, n, l, ref):
    rng = np.random.default_rng(r * 100 + n)
    u = rng.standard_normal((r, n, l)).astype(np.float32)
    w = (rng.random((r, n)) + 0.1).astype(np.float32)
    if r == 3:
        w[1] = 0.0                          # an all-zero weight row
    want = np.asarray(ref.fedavg_batched_pallas(ref.jnp.asarray(u), ref.jnp.asarray(w),
                                            interpret=True))
    got = fedavg_batched_ref(_t(u), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **FEDAVG_TOL)
    if r == 3:
        assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("n,l", [(5, 4096), (1, 513), (4, 1000 + 7)])
def test_fedavg_flat_matches_pallas_and_jnp_oracle(n, l, ref):
    rng = np.random.default_rng(n + l)
    u = rng.standard_normal((n, l)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    got = fedavg_ops.fedavg_flat(_t(u), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.fedavg_pallas(
        ref.jnp.asarray(u), ref.jnp.asarray(w), interpret=True)), **FEDAVG_TOL)
    np.testing.assert_allclose(got, np.asarray(ref.fedavg_ref(ref.jnp.asarray(u),
                                                              ref.jnp.asarray(w))),
                               **FEDAVG_TOL)


def test_fedavg_cpu_dispatch_runs_the_twin_without_launching():
    kernels.reset_launch_counts()
    u, w = torch.randn(1, 3, 10), torch.ones(1, 3)
    assert torch.equal(fedavg_ops.fedavg_flat_batched(u, w), fedavg_batched_ref(u, w))
    assert kernels.launch_counts()["fedavg"] == 0


def test_fedavg_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_batched_cuda(torch.randn(1, 2, 3), torch.ones(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,l", FEDAVG_SHAPES + [(1, 5, 18566), (64, 5, 18566)])
def test_fedavg_kernel_matches_twin_on_card(r, n, l, cuda_device):
    g = torch.Generator().manual_seed(r + n + l)
    u = torch.randn((r, n, l), generator=g).to(cuda_device)
    w = (torch.rand((r, n), generator=g) + 0.1).to(cuda_device)
    if r == 3:
        w[1] = 0.0
    before = kernels.launch_counts()["fedavg"]
    got = fedavg_ops.fedavg_flat_batched(u, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fedavg"] == before + 1
    torch.testing.assert_close(got, fedavg_batched_ref(u, w), **FEDAVG_TOL)


# ---------------------------------------------------------------------------
# LSTM cell
# ---------------------------------------------------------------------------

LSTM_SHAPES = [(8, 6, 16), (33, 5, 40), (1, 6, 16), (32, 6, 64)]


def _lstm_inputs(b, f, h, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in [
        ((b, f), 1.0), ((b, h), 0.5), ((b, h), 0.5), ((f, 4 * h), 0.4),
        ((h, 4 * h), 1.0 / np.sqrt(h)), ((4 * h,), 0.1)]]


@pytest.mark.parametrize("b,f,h", LSTM_SHAPES)
def test_lstm_ref_matches_pallas(b, f, h, ref):
    args = _lstm_inputs(b, f, h, b * f * h)
    hp, cp = ref.lstm_cell_pallas(*(ref.jnp.asarray(a) for a in args), interpret=True)
    ht, ct = lstm_ops.lstm_cell(*(_t(a) for a in args))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hp), **LSTM_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cp), **LSTM_TOL)


@pytest.mark.parametrize("b,f,h", LSTM_SHAPES[:3])
def test_lstm_backward_matches_jax_grad(b, f, h, ref):
    """The autograd Function's hand-written backward against jax.grad of
    the reference cell, for all six inputs."""
    args = _lstm_inputs(b, f, h, 7 + b)
    rng = np.random.default_rng(99)
    a = rng.standard_normal((b, h)).astype(np.float32)
    c = rng.standard_normal((b, h)).astype(np.float32)

    def jloss(*xs):
        hn, cn = ref.jlstm_ref(*xs)
        return ref.jnp.sum(hn * a) + ref.jnp.sum(cn * c)

    want = ref.jax.grad(jloss, argnums=tuple(range(6)))(*(ref.jnp.asarray(x) for x in args))
    targs = [_t(x).requires_grad_(True) for x in args]
    hn, cn = lstm_ops.lstm_cell_autograd(*targs)
    (torch.sum(hn * _t(a)) + torch.sum(cn * _t(c))).backward()
    for name, w, t in zip(("x", "h", "c", "wx", "wh", "b"), want, targs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_lstm_backward_matches_autograd_of_the_twin():
    args = [_t(x).double().requires_grad_(True) for x in _lstm_inputs(4, 3, 5, 1)]
    assert torch.autograd.gradcheck(lstm_ops.lstm_cell_autograd, args)


def test_lstm_kernel_wrapper_rejects_cpu_tensors():
    args = [_t(x) for x in _lstm_inputs(2, 3, 4, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cell_cuda(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,h", LSTM_SHAPES + [(45, 6, 64)])
def test_lstm_kernel_matches_twin_on_card(b, f, h, cuda_device):
    args = [_t(x).to(cuda_device) for x in _lstm_inputs(b, f, h, b + f + h)]
    hk, ck = lstm_ops.lstm_cell(*args)
    torch.cuda.synchronize()
    hr, cr = lstm_cell_ref(*args)
    torch.testing.assert_close(hk, hr, **LSTM_TOL)
    torch.testing.assert_close(ck, cr, **LSTM_TOL)


def _lane_lstm_inputs(lanes, b, f, h, seed):
    per = [_lstm_inputs(b, f, h, seed + i) for i in range(lanes)]
    return [_t(np.stack([p[k] for p in per])) for k in range(6)]


def test_lane_cell_equals_single_lane_calls():
    args = _lane_lstm_inputs(3, 5, 4, 6, 11)
    hl, cl = lstm_ops.lstm_cell(*args)
    for i in range(3):
        hi, ci = lstm_ops.lstm_cell(*(a[i] for a in args))
        torch.testing.assert_close(hl[i], hi, **LSTM_TOL)
        torch.testing.assert_close(cl[i], ci, **LSTM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,b,f,h", [(64, 32, 6, 64), (5, 45, 6, 64), (3, 33, 5, 40)])
def test_lane_cell_kernel_matches_twin_on_card(lanes, b, f, h, cuda_device):
    args = [a.to(cuda_device) for a in _lane_lstm_inputs(lanes, b, f, h, lanes + b)]
    hk, ck = lstm_ops.lstm_cell(*args)
    torch.cuda.synchronize()
    hr, cr = lstm_cell_ref(*args)
    torch.testing.assert_close(hk, hr, **LSTM_TOL)
    torch.testing.assert_close(ck, cr, **LSTM_TOL)


@pytest.mark.cuda
def test_lane_cell_kernel_takes_views_of_a_flat_buffer(cuda_device):
    """Weights as lane-strided views of one (L, P) buffer, as the fleet
    passes them, give the same result as contiguous copies."""
    x, hh, cc, wx, wh, b = _lane_lstm_inputs(4, 8, 6, 16, 3)
    flat = torch.cat([t.reshape(4, -1) for t in (wx, wh, b)], dim=1).to(cuda_device)
    nwx, nwh = wx[0].numel(), wh[0].numel()
    views = (flat[:, :nwx].reshape(wx.shape), flat[:, nwx:nwx + nwh].reshape(wh.shape),
             flat[:, nwx + nwh:])
    dev = [t.to(cuda_device) for t in (x, hh, cc)]
    got = lstm_cell_cuda(*dev, *views)
    want = lstm_cell_cuda(*dev, *(v.contiguous() for v in views))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("width", [18566, 19456])
def test_lane_cell_launcher_accepts_the_fleets_buffer_views(width):
    """The fleet passes wx, wh and b as ``tree_unravel`` views of an (L, P)
    buffer or of an (L, Lp)[:, :P] slice: the launcher's checks take them,
    with the buffer's row stride as the lane stride."""
    from repro_torch.kernels.lstm_cell.kernel import _lane_arg
    from repro_torch.utils.tree import tree_ravel, tree_unravel

    f, h, c = 6, 64, 6
    like = {"b": torch.zeros(4 * h), "b_out": torch.zeros(c), "w_out": torch.zeros(h, c),
            "wh": torch.zeros(h, 4 * h), "wx": torch.zeros(f, 4 * h)}
    _, spec = tree_ravel(like)
    p = tree_unravel(spec, torch.zeros(5, width)[:, :18566])
    strides = [_lane_arg(k, p[k], (5,) + tuple(p[k].shape[1:]), torch.device("cpu"))
               for k in ("wx", "wh", "b")]
    assert strides == [width] * 3
    with pytest.raises(ValueError, match="contiguous within a lane"):
        _lane_arg("wx", p["wx"].transpose(1, 2), (5, 4 * h, f), torch.device("cpu"))


# the whole-sequence forward and backward kernels: (L, B, F, H, T) at the
# fleet's fit and scoring shapes, the loop engine's, and edge shapes
SEQ_SHAPES = [(64, 32, 6, 64, 32), (1, 32, 6, 64, 32), (1, 45, 6, 64, 32),
              (64, 45, 6, 64, 32), (1, 1, 6, 64, 1), (64, 32, 6, 64, 64), (3, 33, 5, 40, 8),
              (2, 7, 3, 5, 3)]
# the backward: T reverse steps and a batched product over T * B rows, in
# another order than the twin's per-step sums, relative to the largest value
SEQ_BWD_REL = 1e-4


def _seq_inputs_as_fleet_views(lanes, b, f, h, t, dev):
    """x_seq, h0, c0 and the weights as lane-strided views of one flat
    (L, P + 7) buffer, as ``tree_unravel`` gives them to the fleet."""
    g = torch.Generator().manual_seed(lanes + b + f + h + t)
    x = torch.randn((lanes, t, b, f), generator=g)
    h0, c0 = (torch.randn((lanes, b, h), generator=g) * 0.5 for _ in range(2))
    nwx, nwh = f * 4 * h, h * 4 * h
    flat = torch.randn((lanes, nwx + nwh + 4 * h + 7), generator=g) * 0.3
    flat[:, nwx:nwx + nwh] *= 1.0 / (0.3 * h ** 0.5)
    flat = flat.to(dev)
    views = (flat[:, :nwx].view(lanes, f, 4 * h), flat[:, nwx:nwx + nwh].view(lanes, h, 4 * h),
             flat[:, nwx + nwh:nwx + nwh + 4 * h])
    return [x.to(dev), h0.to(dev), c0.to(dev), *views]


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,b,f,h,t", SEQ_SHAPES)
def test_seq_kernels_match_twins_on_card(lanes, b, f, h, t, cuda_device):
    from repro_torch.kernels.lstm_cell.kernel import lstm_seq_backward_cuda, lstm_seq_cuda
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref

    args = _seq_inputs_as_fleet_views(lanes, b, f, h, t, cuda_device)
    before = kernels.launch_counts()
    hs, cs = lstm_seq_cuda(*args, save=True)
    h_t, c_t = lstm_seq_cuda(*args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["lstm_cell"] == before["lstm_cell"] + 2
    hr, cr = lstm_seq_ref(*args)
    torch.testing.assert_close(hs, hr, **LSTM_TOL)
    torch.testing.assert_close(cs, cr, **LSTM_TOL)
    assert torch.equal(h_t, hs[:, -1]) and torch.equal(c_t, cs[:, -1])
    assert torch.equal(hs[:, 0], args[1]) and torch.equal(cs[:, 0], args[2])

    g = torch.Generator().manual_seed(7)
    dh, dc = (torch.randn((lanes, b, h), generator=g).to(cuda_device) for _ in range(2))
    x, wx, wh, bias = args[0], args[3], args[4], args[5]
    dgates, dh0, dc0 = lstm_seq_backward_cuda(x, hs, cs, wx, wh, bias, dh, dc)
    full = lstm_ops.lstm_seq_backward(x, hs, cs, wx, wh, bias, dh, dc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lstm_cell_bwd"] == after["lstm_cell_bwd"] + 2
    want = lstm_seq_backward_ref(x, hs, cs, wx, wh, bias, dh, dc)
    for name, got, w in zip(("dgates", "dh0", "dc0", "dx", "dwx", "dwh", "db"),
                            (dgates, dh0, dc0) + tuple(full[3:]), want):
        assert _rel_err(got, w) <= SEQ_BWD_REL, name
    assert torch.equal(full[0], dgates)


@pytest.mark.cuda
def test_seq_kernels_take_views_of_a_flat_buffer(cuda_device):
    """Weights as lane-strided views give the results of contiguous copies,
    bit for bit, in both kernels."""
    from repro_torch.kernels.lstm_cell.kernel import lstm_seq_backward_cuda, lstm_seq_cuda

    args = _seq_inputs_as_fleet_views(4, 9, 6, 16, 5, cuda_device)
    dense = args[:3] + [a.contiguous() for a in args[3:]]
    got, want = lstm_seq_cuda(*args, save=True), lstm_seq_cuda(*dense, save=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dh = torch.ones_like(args[1])
    gb = lstm_seq_backward_cuda(args[0], *got, *args[3:], dh, dh)
    wb = lstm_seq_backward_cuda(dense[0], *want, *dense[3:], dh, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))


@pytest.mark.cuda
def test_seq_function_on_card_matches_the_cpu(cuda_device):
    """The classifier's path, LSTMSeqFunction forward and backward, on the
    card against the same Function on the CPU."""
    host = _seq_inputs_as_fleet_views(3, 32, 6, 64, 32, torch.device("cpu"))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        ins = [a.to(dev).clone().requires_grad_(True) for a in host]
        h_t, c_t = lstm_ops.LSTMSeqFunction.apply(*ins)
        (h_t.sum() + (c_t * c_t).sum()).backward()
        outs.append([h_t.detach().cpu()] + [a.grad.cpu() for a in ins])
    for name, got, want in zip(("h_T", "x", "h0", "c0", "wx", "wh", "b"), *outs):
        assert _rel_err(got, want) <= SEQ_BWD_REL, name


# ---------------------------------------------------------------------------
# int8 wire: quantize, dequantize, fused q8 eq. 14
# ---------------------------------------------------------------------------


def _quant_cases():
    """(name, x (B, L)) cases: off-tile, a zero tile, exact half-way codes."""
    rng = np.random.default_rng(5)
    half = np.zeros((1, 2048), np.float32)
    half[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]        # scale 1: x/s = k + 0.5
    half[0, 1024:1030] = [-127.0, 126.5, -126.5, 3.5, 4.5, -3.5]
    zero_tile = rng.standard_normal((3, 3072)).astype(np.float32)
    zero_tile[1, 1024:2048] = 0.0
    return [("main 1-D", rng.standard_normal((1, 18566)).astype(np.float32)),
            ("rows", rng.standard_normal((320, 2048)).astype(np.float32) * 0.1),
            ("off-tile", rng.standard_normal((2, 1000 + 7)).astype(np.float32)),
            ("zero tile", zero_tile), ("half-way", half)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_quantize_kernel_matches_twin_bit_for_bit_on_card(case, cuda_device):
    name, x = _quant_cases()[case]
    xd = _t(x).to(cuda_device)
    q, s = quant_ops.quantize_flat_batched(xd)
    torch.cuda.synchronize()
    qr, sr = quantize_batched_ref(xd)
    assert torch.equal(q, qr), name
    assert torch.equal(s, sr), name
    q1, s1, n = quant_ops.compress_update(xd[0])
    assert torch.equal(q1, qr[0]) and torch.equal(s1, sr[0]) and n == x.shape[1]
    back = quant_ops.decompress_update(q1, s1, n)
    torch.cuda.synchronize()
    assert torch.equal(back, dequantize_ref(qr[0], sr[0], n))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,lp", [(64, 5, 19456), (3, 4, 2048), (1, 1, 1024)])
def test_fedavg_q8_kernel_matches_twin_on_card(r, n, lp, cuda_device):
    g = torch.Generator().manual_seed(r + n + lp)
    q, s = quantize_batched_ref(torch.randn((r * n, lp), generator=g))
    q, s = q.reshape(r, n, lp).to(cuda_device), s.reshape(r, n, -1).to(cuda_device)
    w = (torch.rand((r, n), generator=g) + 0.1).to(cuda_device)
    if r > 1:
        w[1] = 0.0
    got = fedavg_ops.fedavg_flat_batched_q8(q, s, w)
    torch.cuda.synchronize()
    want = fedavg_batched_q8_ref(q, s, w)
    assert float((got - want).abs().max()) <= 1e-6 * max(float(want.abs().max()), 1.0)
    if r > 1:
        assert bool((got[1] == 0).all())


def test_quantize_cpu_dispatch_runs_the_twins_without_launching():
    kernels.reset_launch_counts()
    x = torch.randn(2, 1500)
    q, s = quant_ops.quantize_flat_batched(x)
    assert (q.shape, s.shape) == ((2, 2048), (2, 2))
    qf, sf, n = quant_ops.compress_update(x[0])
    assert torch.equal(qf, q[0]) and n == 1500
    assert quant_ops.decompress_update(qf, sf, n).shape == (1500,)
    u = fedavg_ops.fedavg_flat_batched_q8(q[None], s[None], torch.ones(1, 2))
    assert torch.equal(u, fedavg_batched_ref(dequantize_batched_ref(q, s)[None],
                                             torch.ones(1, 2)))
    counts = kernels.launch_counts()
    assert set(counts) == {"fedavg", "fedavg_q8", "lstm_cell", "lstm_cell_bwd", "aes_ctr",
                           "quantize",
                           "dequantize", "trimmed_mean", "trimmed_mean_q8", "median",
                           "median_q8", "sqnorm", "sqnorm_q8"}
    assert not any(counts.values())


def test_int8_kernel_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        quantize_cuda(torch.randn(2, 1024))
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_cuda(torch.zeros(1024, dtype=torch.int8), torch.ones(1), 10)
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_batched_q8_cuda(torch.zeros(1, 2, 1024, dtype=torch.int8),
                               torch.ones(1, 2, 1), torch.ones(1, 2))


# ---------------------------------------------------------------------------
# robust statistics (trimmed mean, median, squared norm; dense and int8)
# ---------------------------------------------------------------------------

ROBUST_SHAPES = [(64, 5, 18566), (3, 6, 1000 + 7), (2, 1, 300), (2, 2, 513), (4, 3, 256),
                 (5, 16, 777)]


def _robust_world(r, n, l, seed):
    """Normal values with an all-zero weight row, ties and a noise-sized
    outlier, as int8 codes + scales and their dequantized fp32 buffer."""
    g = torch.Generator().manual_seed(seed)
    lp = l + (-l) % 1024
    x = torch.randn((r, n, l), generator=g)
    x[0, 0, : min(l, 64)] *= 1e3                               # a noise-sized outlier
    if n > 2:
        x[-1, 1] = x[-1, 0]                                    # tied rows
    q, s = quantize_batched_ref(x.reshape(r * n, l))
    q, s = q.reshape(r, n, lp), s.reshape(r, n, -1)
    w = torch.rand((r, n), generator=g) + 0.1
    w[0, -1] = 0.0                                             # an inactive lane
    if r > 1:
        w[1] = 0.0                                             # an all-zero weight row
    return x, q, s, dequantize_batched_ref(q, s), w


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,l", ROBUST_SHAPES)
def test_robust_kernels_match_twins_on_card(r, n, l, cuda_device):
    x, q, s, dq, w = (t.to(cuda_device) for t in _robust_world(r, n, l, r + n + l))
    for dense_k, q8_k, twin in ((robust_kernel.trimmed_mean_cuda,
                                 robust_kernel.trimmed_mean_q8_cuda,
                                 robust_ref.trimmed_mean_batched_ref),
                                (robust_kernel.median_cuda, robust_kernel.median_q8_cuda,
                                 robust_ref.median_batched_ref)):
        got = dense_k(x.contiguous(), w)
        want = twin(x, w)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-6 * max(float(want.abs().max()), 1.0)
        if r > 1:
            assert bool((got[1] == 0).all())
        # the q8 kernel is bitwise the dense kernel on the dequantized buffer
        assert torch.equal(q8_k(q, s, w), dense_k(dq.contiguous(), w))
    sq = robust_kernel.sqnorm_cuda(x.contiguous())
    torch.testing.assert_close(sq, robust_ref.sqnorm_batched_ref(x), rtol=1e-5, atol=1e-6)
    # the q8 sum over the padded Lp is bitwise the dense sum over P
    sq8 = robust_kernel.sqnorm_q8_cuda(q, s)
    assert torch.equal(sq8, robust_kernel.sqnorm_cuda(dq[..., :l].contiguous()))
    assert torch.equal(sq8, robust_kernel.sqnorm_cuda(dq.contiguous()))


@pytest.mark.cuda
def test_robust_kernels_are_deterministic_and_reject_too_many_contributors(cuda_device):
    x = torch.randn((4, 5, 4099), device=cuda_device)
    a, b = robust_kernel.sqnorm_cuda(x), robust_kernel.sqnorm_cuda(x)
    assert torch.equal(a, b)
    w = torch.ones((1, robust_kernel.MAX_N + 1), device=cuda_device)
    u = torch.zeros((1, robust_kernel.MAX_N + 1, 8), device=cuda_device)
    for call in (robust_kernel.trimmed_mean_cuda, robust_kernel.median_cuda):
        with pytest.raises(ValueError, match=f"1 to {robust_kernel.MAX_N}"):
            call(u, w)


# ---------------------------------------------------------------------------
# AES-128-CTR
# ---------------------------------------------------------------------------

AES_SIZES = [7, 16, 1000 + 5, 4096 + 8]


def test_fips197_block_through_the_port():
    key = np.arange(16, dtype=np.uint8)
    block = torch.tensor([list(bytes.fromhex("00112233445566778899aabbccddeeff"))],
                         dtype=torch.uint8)
    out = crypto.aes128_encrypt_blocks(block, crypto.expand_key(key))
    assert bytes(out[0].tolist()).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_tables_and_key_schedule_match_reference(ref):
    assert np.array_equal(crypto.TABLES[0], ref.jcrypto._SBOX)
    assert np.array_equal(crypto.TABLES[1], ref.jcrypto._MUL2)
    assert np.array_equal(crypto.TABLES[2], ref.jcrypto._MUL3)
    key = np.random.default_rng(0).integers(0, 256, 16).astype(np.uint8)
    assert np.array_equal(crypto.expand_key(key), ref.jcrypto.expand_key(key))


def test_counter_blocks_match_reference(ref):
    nonce = np.random.default_rng(1).integers(0, 256, 8).astype(np.uint8)
    got = counter_blocks_ref(_t(nonce), 300).numpy()
    assert np.array_equal(got, ref.jcrypto._counter_blocks(nonce, 300))


@pytest.mark.parametrize("n", AES_SIZES)
def test_aes_ref_matches_pallas_byte_exact(n, ref):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 256, 16).astype(np.uint8)
    nonce = rng.integers(0, 256, 8).astype(np.uint8)
    pay = rng.integers(0, 256, n).astype(np.uint8)
    rk = ref.jcrypto.expand_key(key)
    ctr = ref.jcrypto._counter_blocks(nonce, (n + 15) // 16)
    want = np.asarray(ref.aes_ctr_pallas(ref.jnp.asarray(pay), ref.jnp.asarray(rk),
                                         ref.jnp.asarray(ctr), interpret=True))
    got = aes_ctr_ref(_t(pay), _t(rk), _t(nonce), _t(crypto.TABLES)).numpy()
    assert np.array_equal(got, want)
    port = crypto.encrypt_bytes(_t(pay), key, nonce).numpy()
    want_port = ref.jcrypto.encrypt_bytes(ref.jnp.asarray(pay), key, nonce)
    assert np.array_equal(port, np.asarray(want_port))
    assert np.array_equal(crypto.decrypt_bytes(_t(port), key, nonce).numpy(), pay)


def test_update_bytes_are_little_endian_fp32(ref):
    vec = np.random.default_rng(3).standard_normal(33).astype(np.float32)
    got = crypto.float_vector_to_bytes(_t(vec)).numpy()
    want = ref.jcrypto.float_vector_to_bytes(ref.jnp.asarray(vec))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(crypto.bytes_to_float_vector(_t(got)).numpy(), vec)


def test_aes_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        aes_ctr_cuda(torch.zeros(16, dtype=torch.uint8), torch.zeros(11, 16, dtype=torch.uint8),
                     torch.zeros(8, dtype=torch.uint8), _t(crypto.TABLES))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(n, 0) for n in AES_SIZES] + [(74264, 0), (1003, 1)])
def test_aes_kernel_matches_twin_on_card(n, offset, cuda_device):
    rng = np.random.default_rng(n + offset)
    rk = _t(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8))).to(cuda_device)
    nonce = _t(rng.integers(0, 256, 8).astype(np.uint8)).to(cuda_device)
    tables = _t(crypto.TABLES).to(cuda_device)
    buf = _t(rng.integers(0, 256, n + offset).astype(np.uint8)).to(cuda_device)
    pay = buf[offset:]
    got = aes_ops.aes_ctr(pay, rk, nonce, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ctr_ref(pay, rk, nonce, tables))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def test_build_covers_every_source_and_hashes_them(tmp_path, monkeypatch):
    names = {p.name for p in _build.sources()}
    assert names == {"fedavg.cu", "lstm_cell.cu", "aes_ctr.cu", "quantize.cu", "robust.cu"}
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    h = _build.source_hash()
    for src in _build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() == h
    (tmp_path / "fedavg.cu").write_text((tmp_path / "fedavg.cu").read_text() + "\n// edit\n")
    assert _build.source_hash() != h


def test_launchers_declare_pointer_args_as_void_p():
    from repro_torch.kernels.aes_ctr import kernel as ak
    from repro_torch.kernels.fedavg import kernel as fk
    from repro_torch.kernels.lstm_cell import kernel as lk
    from repro_torch.kernels.quantize import kernel as qk

    rk = robust_kernel
    for argtypes in (fk._ARGTYPES, fk._Q8_ARGTYPES, lk._FWD_ARGTYPES, lk._BWD_ARGTYPES,
                     ak._ARGTYPES,
                     qk._QUANT_ARGTYPES, qk._DEQUANT_ARGTYPES, rk._COLUMN_ARGTYPES,
                     rk._COLUMN_Q8_ARGTYPES, rk._SQNORM_ARGTYPES, rk._SQNORM_Q8_ARGTYPES):
        assert argtypes[-1] is ctypes.c_void_p            # the stream
        assert set(argtypes) <= {ctypes.c_void_p, ctypes.c_int}
