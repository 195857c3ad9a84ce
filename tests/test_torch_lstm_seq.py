"""The whole-sequence LSTM of the port (``repro_torch.kernels.lstm_cell``):
its plain twins against ``jax.lax.scan`` of the JAX package's cell and
against the Pallas kernel in interpret mode, its autograd Function against
``jax.grad`` and ``gradcheck``, and the launchers' argument checks.  The
CUDA kernels themselves are held against these twins on the card by
``tests/test_torch_kernels.py`` (marker ``cuda``) and ``chip_smoke.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch import kernels
from repro_torch.kernels.lstm_cell import kernel as lk
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import (lstm_cell_backward_ref, lstm_cell_ref,
                                               lstm_seq_backward_ref, lstm_seq_ref)

# T steps of fp32 matmuls and transcendentals, in another order than XLA's
FWD_TOL = dict(rtol=0, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)

# (L, T, B, F, H); L = 0 means no lane axis
SHAPES = [(1, 1, 1, 3, 5), (1, 3, 5, 6, 16), (3, 8, 5, 3, 5), (3, 3, 1, 6, 16),
          (0, 8, 5, 6, 16), (3, 1, 5, 3, 16)]


@pytest.fixture
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.lstm_cell.kernel import lstm_cell_pallas
    from repro.kernels.lstm_cell.ref import lstm_cell_ref as jcell

    def scan(cell, x_seq, h0, c0, wx, wh, b):
        """(h_seq, c_seq) of one lane, (T+1, B, H), by ``lax.scan``."""
        def step(carry, x):
            h, c = cell(x, *carry, wx, wh, b)
            return (h, c), (h, c)
        _, (hs, cs) = jax.lax.scan(step, (h0, c0), x_seq)
        return jnp.concatenate([h0[None], hs]), jnp.concatenate([c0[None], cs])

    return jax, jnp, jcell, lstm_cell_pallas, scan


def _inputs(lanes, t, b, f, h, seed):
    """numpy (x_seq, h0, c0, wx, wh, b), with the lane axis unless L = 0."""
    rng = np.random.default_rng(seed)
    lead = (lanes,) if lanes else ()
    return [(rng.standard_normal(lead + s) * sc).astype(np.float32) for s, sc in [
        ((t, b, f), 1.0), ((b, h), 0.5), ((b, h), 0.5), ((f, 4 * h), 0.4),
        ((h, 4 * h), 1.0 / np.sqrt(h)), ((4 * h,), 0.1)]]


def _per_lane(args, lanes):
    return [[a[i] for a in args] for i in range(lanes)] if lanes else [args]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("lanes,t,b,f,h", SHAPES)
def test_seq_forward_matches_jax_scan(lanes, t, b, f, h, jref):
    jax, jnp, jcell, _, scan = jref
    args = _inputs(lanes, t, b, f, h, lanes + 10 * t + b)
    h_seq, c_seq = ops.lstm_seq(*(_t(a) for a in args), save=True)
    want = [scan(jcell, *(jnp.asarray(a) for a in lane)) for lane in _per_lane(args, lanes)]
    want_h = np.stack([np.asarray(w[0]) for w in want]) if lanes else np.asarray(want[0][0])
    want_c = np.stack([np.asarray(w[1]) for w in want]) if lanes else np.asarray(want[0][1])
    np.testing.assert_allclose(h_seq.numpy(), want_h, **FWD_TOL)
    np.testing.assert_allclose(c_seq.numpy(), want_c, **FWD_TOL)
    h_t, c_t = ops.lstm_seq(*(_t(a) for a in args))
    assert torch.equal(h_t, h_seq[..., -1, :, :]) and torch.equal(c_t, c_seq[..., -1, :, :])


def test_seq_forward_matches_scanned_pallas_kernel(jref):
    jax, jnp, _, pallas, scan = jref
    args = _inputs(0, 8, 5, 6, 16, 3)
    cell = lambda *a: pallas(*a, interpret=True)   # noqa: E731
    want_h, want_c = scan(cell, *(jnp.asarray(a) for a in args))
    h_seq, c_seq = ops.lstm_seq(*(_t(a) for a in args), save=True)
    np.testing.assert_allclose(h_seq.numpy(), np.asarray(want_h), **FWD_TOL)
    np.testing.assert_allclose(c_seq.numpy(), np.asarray(want_c), **FWD_TOL)


@pytest.mark.parametrize("lanes,t,b,f,h", SHAPES)
def test_seq_function_gradients_match_jax_grad(lanes, t, b, f, h, jref):
    """All six gradients of LSTMSeqFunction against ``jax.grad`` of the
    scanned reference cell, under a loss on both final states."""
    jax, jnp, jcell, _, scan = jref
    args = _inputs(lanes, t, b, f, h, 100 + lanes + t)
    rng = np.random.default_rng(5)
    lead = (lanes,) if lanes else ()
    ah = rng.standard_normal(lead + (b, h)).astype(np.float32)
    ac = rng.standard_normal(lead + (b, h)).astype(np.float32)

    def jloss(*xs, ah, ac):
        hs, cs = scan(jcell, *xs)
        return jnp.sum(hs[-1] * ah) + jnp.sum(cs[-1] * ac)

    grad = jax.grad(jloss, argnums=tuple(range(6)))
    if lanes:
        per = [grad(*(jnp.asarray(a) for a in lane), ah=ah[i], ac=ac[i])
               for i, lane in enumerate(_per_lane(args, lanes))]
        want = [np.stack([np.asarray(p[k]) for p in per]) for k in range(6)]
    else:
        want = [np.asarray(g) for g in grad(*(jnp.asarray(a) for a in args), ah=ah, ac=ac)]
    targs = [_t(a).requires_grad_(True) for a in args]
    h_t, c_t = ops.LSTMSeqFunction.apply(*targs)
    (torch.sum(h_t * _t(ah)) + torch.sum(c_t * _t(ac))).backward()
    for name, w, x in zip(("x_seq", "h0", "c0", "wx", "wh", "b"), want, targs):
        np.testing.assert_allclose(x.grad.numpy(), w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("lanes", [0, 2])
def test_seq_function_gradcheck_float64(lanes):
    args = [_t(a).double().requires_grad_(True) for a in _inputs(lanes, 3, 4, 3, 5, 1)]
    assert torch.autograd.gradcheck(ops.LSTMSeqFunction.apply, args)


def test_lane_form_equals_per_lane_calls():
    lanes = 3
    args = [_t(a) for a in _inputs(lanes, 8, 5, 6, 16, 21)]
    cot = [torch.randn((lanes, 5, 16), generator=torch.Generator().manual_seed(s))
           for s in (1, 2)]
    h_seq, c_seq = ops.lstm_seq(*args, save=True)
    grads = ops.lstm_seq_backward(args[0], h_seq, c_seq, *args[3:], *cot)
    for i in range(lanes):
        hi, ci = ops.lstm_seq(*(a[i] for a in args), save=True)
        assert torch.equal(hi, h_seq[i]) and torch.equal(ci, c_seq[i])
        gi = ops.lstm_seq_backward(args[0][i], hi, ci, *(a[i] for a in args[3:]),
                                   cot[0][i], cot[1][i])
        for name, lane_g, one_g in zip(("dgates", "dh0", "dc0", "dx", "dwx", "dwh", "db"),
                                       grads, gi):
            torch.testing.assert_close(lane_g[i], one_g, rtol=1e-6, atol=1e-6, msg=name)


def test_t1_is_the_cell():
    args = [_t(a) for a in _inputs(3, 1, 5, 6, 16, 4)]
    x, rest = args[0][:, 0], args[1:]
    h_seq, c_seq = lstm_seq_ref(*args)
    h1, c1 = lstm_cell_ref(x, *rest)
    assert torch.equal(h_seq[:, 1], h1) and torch.equal(c_seq[:, 1], c1)
    dh, dc = torch.randn(3, 5, 16), torch.randn(3, 5, 16)
    seq = lstm_seq_backward_ref(args[0], h_seq, c_seq, *args[3:], dh, dc)
    cell = lstm_cell_backward_ref(x, *rest, dh, dc)
    for s, c in zip((seq[3][:, 0],) + seq[1:3] + seq[4:], cell):
        assert torch.equal(s, c)
    hc, cc = ops.lstm_cell_autograd(x, *rest)
    assert torch.equal(hc, h1) and torch.equal(cc, c1)


def test_saved_states_start_with_the_initial_state():
    args = [_t(a) for a in _inputs(2, 3, 5, 6, 16, 8)]
    h_seq, c_seq = ops.lstm_seq(*args, save=True)
    assert h_seq.shape == c_seq.shape == (2, 4, 5, 16)
    assert torch.equal(h_seq[:, 0], args[1]) and torch.equal(c_seq[:, 0], args[2])


class _StepFunction(torch.autograd.Function):
    """One cell step with the twin's hand-written backward: T of these in
    a Python loop is how the classifier ran the cell before the sequence
    kernels."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return lstm_cell_ref(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh, dc):
        return lstm_cell_backward_ref(*ctx.saved_tensors, dh, dc)


@pytest.mark.parametrize("lanes", [1, 3])
def test_seq_function_on_cpu_equals_t_cell_nodes_bit_for_bit(lanes):
    """The CPU twin sums the per-step weight gradients in autograd's order,
    so the loop engine and the fleet give the same numbers on the host as
    the per-step cell nodes did."""
    args = [_t(a) for a in _inputs(lanes, 8, 5, 6, 16, 31)]
    head = torch.randn((lanes, 16, 6), generator=torch.Generator().manual_seed(0))

    def grads(run):
        w = [a.clone().requires_grad_(True) for a in args[3:]]
        h = run(args[0], args[1], args[2], *w)
        torch.sum(torch.tanh(h @ head)).backward()
        return [t.grad for t in w]

    def stepwise(x_seq, h, c, wx, wh, b):
        for t in range(x_seq.shape[1]):
            h, c = _StepFunction.apply(x_seq[:, t].contiguous(), h, c, wx, wh, b)
        return h

    new = grads(lambda *a: ops.lstm_seq_autograd(*a)[0])
    old = grads(stepwise)
    for name, n, o in zip(("wx", "wh", "b"), new, old):
        assert torch.equal(n, o), name


def test_no_grad_forward_saves_nothing_and_matches_the_function():
    args = [_t(a) for a in _inputs(2, 8, 5, 6, 16, 9)]
    with torch.no_grad():
        h, c = ops.lstm_seq_autograd(*args)
    wants = ops.LSTMSeqFunction.apply(*(a.clone().requires_grad_(True) for a in args))
    assert torch.equal(h, wants[0].detach()) and torch.equal(c, wants[1].detach())


def test_cpu_dispatch_runs_the_twins_without_launching():
    kernels.reset_launch_counts()
    args = [_t(a).requires_grad_(True) for a in _inputs(2, 3, 5, 6, 16, 2)]
    h, _ = ops.lstm_seq_autograd(*args)
    h.sum().backward()
    counts = kernels.launch_counts()
    assert counts["lstm_cell"] == 0 and counts["lstm_cell_bwd"] == 0


@pytest.mark.parametrize("backward", [False, True])
def test_launcher_refuses_weights_over_shared_memory(backward):
    """H = 128 at F = 6 does not fit a block's 227 KB: refused by the plan,
    before the device is looked at, with the limit named."""
    assert lk.plan(32, 6, 64, backward)[1] <= lk.MAX_SHARED_BYTES
    args = [_t(a) for a in _inputs(1, 2, 4, 6, 128, 0)]
    with pytest.raises(ValueError, match=f"{lk.MAX_SHARED_BYTES} B"):
        if backward:
            h_seq = torch.zeros(1, 3, 4, 128)
            lk.lstm_seq_backward_cuda(args[0], h_seq, h_seq, *args[3:], args[1], args[2])
        else:
            lk.lstm_seq_cuda(*args)


def test_plan_fills_the_fleet_grid_and_matches_the_stated_layout():
    """At H = 64 a block is 4 x 64 threads over a 16-row batch tile (the
    fleet's 64 lanes x B = 32 give 128 blocks); the weights take 71.7 KB."""
    groups, smem = lk.plan(32, 6, 64)
    assert groups * lk.ROWS == 16
    assert 70 * 257 * 4 < smem < 96 * 1024
    assert lk.plan(1, 6, 64)[0] == 1                 # B = 1: a 4-row tile
    assert lk.plan(45, 3, 5)[0] * 5 <= lk.THREADS


def test_launchers_reject_cpu_tensors():
    args = [_t(a) for a in _inputs(2, 3, 4, 6, 16, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        lk.lstm_seq_cuda(*args)
    h_seq = torch.zeros(2, 4, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        lk.lstm_seq_backward_cuda(args[0], h_seq, h_seq, *args[3:], args[1], args[2])


@pytest.mark.parametrize("name,argtypes", [("lstm_seq_fwd_launch", lk._FWD_ARGTYPES),
                                           ("lstm_seq_bwd_launch", lk._BWD_ARGTYPES)])
def test_argtypes_follow_the_c_signatures(name, argtypes):
    """The ctypes declarations list the C launcher's parameters in order:
    a pointer for every ``void*``, an int for every ``int``."""
    src = (Path(lk.__file__).resolve().parents[2] / "csrc" / "lstm_cell.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "void*" in p else ctypes.c_int for p in params.split(",")]
    assert all("void*" in p or p.split()[0] == "int" for p in params.split(","))
    assert kinds == argtypes
