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
          (0, 8, 5, 6, 16), (3, 1, 5, 3, 16), (1, 3, 5, 6, 128), (2, 2, 3, 9, 130)]


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


@pytest.mark.parametrize("need_dx", [True, False])
def test_backward_charges_its_kernel_and_counts_the_weight_products_apart(monkeypatch,
                                                                           need_dx):
    """Under the program-cost recorder the backward charges the kernel's own
    work (dgates, dh0, dc0) to ``lstm_cell_bwd``; the weight-gradient
    products it forms in plain torch beside the kernel go to
    ``torch_matmul_flops``, at the count ``FlopCounterMode`` gives the
    card's batched products (run here on CPU tensors, the kernel's three
    outputs taken from the twin)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.telemetry import record_program_cost

    lanes, t, b, f, h = 3, 8, 5, 6, 16
    args = [_t(a) for a in _inputs(lanes, t, b, f, h, 5)]
    cot = [torch.randn((lanes, b, h), generator=torch.Generator().manual_seed(s))
           for s in (1, 2)]
    h_seq, c_seq = ops.lstm_seq(*args, save=True)
    with record_program_cost() as rec:
        ops.lstm_seq_backward(args[0], h_seq, c_seq, *args[3:], *cot, need_dx=need_dx)
    assert rec.per_kernel == {"lstm_cell_bwd": ops.lstm_seq_backward_cost(lanes, b, f, h, t)}
    want = ops.lstm_weight_grad_flops(lanes, b, f, h, t, need_dx)
    assert rec.torch_matmul_flops == want
    kernel_out = lstm_seq_backward_ref(args[0], h_seq, c_seq, *args[3:], *cot)[:3]
    monkeypatch.setattr(ops, "lstm_seq_backward_cuda", lambda *a: kernel_out)
    with FlopCounterMode(display=False) as mode:
        ops._backward_lanes(args[0], h_seq, c_seq, *args[3:], *cot, need_dx)
    assert mode.get_total_flops() == want


def _plan_before(batch, f, hidden, backward):
    """(groups, smem) of the one layout the launchers had before the
    weights-through-L2 layout, or None where they refused the shape."""
    groups = max(1, min(lk.THREADS // hidden, -(-batch // lk.ROWS)))
    smem = lk._shared_bytes(f, hidden, groups * lk.ROWS, backward)
    return (groups, smem) if hidden <= 1024 and smem <= lk.MAX_SHARED_BYTES else None


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("f,h", [(6, 113), (6, 128), (9, 111), (6, 256), (142, 64), (6, 1100)])
def test_plan_takes_shapes_past_a_blocks_shared_memory(f, h, backward):
    """Shapes whose weights pass a block's 227 KB at the launchers' first
    choice of batch-row groups: the plan takes each, in the shared-memory
    layout with fewer groups where that fits, else with the weights through
    L2, and never asks for more than a block's shared memory.  The launcher
    then gets past the plan to the device check."""
    p = lk.plan(32, f, h, backward)
    assert p.layout in lk.LAYOUTS
    assert 0 <= p.smem <= lk.MAX_SHARED_BYTES
    threads = lk.MAX_THREADS if p.layout == "smem" else lk.L2_THREADS
    assert p.span * p.groups <= threads and p.span * -(-h // p.span) >= h
    if p.layout == "smem":
        assert p.span == h and p.smem == lk._shared_bytes(f, h, p.groups * lk.ROWS, backward)
    else:
        assert h > 112
    if p.layout == "l2":
        assert h > GRID_CAP[backward]
    assert _plan_before(32, f, h, True) is None       # the pair could not train it
    args = [_t(a) for a in _inputs(1, 2, 4, f, h, 0)]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if backward:
            h_seq = torch.zeros(1, 3, 4, h)
            lk.lstm_seq_backward_cuda(args[0], h_seq, h_seq, *args[3:], args[1], args[2])
        else:
            lk.lstm_seq_cuda(*args)


def test_plan_keeps_every_shape_that_fit_before():
    """Every shape the shared-memory layout took before keeps its layout,
    groups and shared memory, so it runs the same launch; past it, fewer
    groups, then the weights through L2 (its state in shared memory, then
    the backward's dgates tile in the output, then the state in a scratch
    buffer; past the streamed grid's cap, at B = 128 and 32)."""
    for batch in (1, 5, 32, 45):
        for f in (1, 3, 6, 9, 141):
            for h in range(1, 131):
                for backward in (False, True):
                    before = _plan_before(batch, f, h, backward)
                    if before is not None:
                        p = lk.plan(batch, f, h, backward)
                        assert (p.layout, p.groups, p.smem) == ("smem",) + before
    assert lk.plan(32, 6, 113, True)[:3] == ("smem", 1, 226_528)
    assert lk.plan(128, 6, 2100, True).mode == lk.DGATES_OUT
    big = lk.plan(32, 6, 5000, True)
    assert big.mode == lk.STATE_GLOBAL | lk.DGATES_OUT and big.state > 0
    assert big.smem == 4 * lk._l2_stage_floats(big.span)   # only the stage of wh
    assert lk.plan(32, 6, 64, _layout="l2").layout == "l2"
    with pytest.raises(ValueError, match="shared memory"):
        lk.plan(32, 6, 128, _layout="smem")


def test_plan_fills_the_fleet_grid_and_matches_the_stated_layout():
    """At H = 64 a block is 4 x 64 threads over a 16-row batch tile (the
    fleet's 64 lanes x B = 32 give 128 blocks); the weights take 71.7 KB."""
    p = lk.plan(32, 6, 64)
    assert p.layout == "smem" and p.groups * lk.ROWS == 16
    assert 70 * 257 * 4 < p.smem < 96 * 1024
    assert lk.plan(1, 6, 64).groups == 1                 # B = 1: a 4-row tile
    assert lk.plan(45, 3, 5).groups * 5 <= lk.THREADS


# the largest H of the cluster layout at F = 6 (forward, backward)
CLUSTER_CAP = {False: 461, True: 334}
# the largest H of the grid layout at F = 6, B = 32, each block holding its
# whole share (the unstreamed grid)
GRID_CAP = {False: 924, True: 660}
# the largest H of the grid layout at F = 6, B = 32 with streaming: K
# blocks of at most 256 threads (Hc <= 32 at a 32-row tile) on 132 SMs
STREAM_CAP = 4224


@pytest.mark.parametrize("backward", [False, True])
def test_plan_picks_the_cluster_up_to_its_cap(backward):
    """Past the shared-memory layout, every H up to the cap at F = 6, and
    (F, H) = (9, 128), take the cluster layout, at one lane and at the
    fleet's 64; past the cap a lane's weights go across the card (at
    H = 1,100 streamed), and past the streamed grid's cap through L2."""
    cap = CLUSTER_CAP[backward]
    for lanes in (1, 64):
        for h in range(115, cap + 1):
            p = lk.plan(32, 6, h, backward, lanes=lanes)
            want = "smem" if _plan_before(32, 6, h, backward) else "cluster"
            assert p.layout == want, (lanes, h)
        assert lk.plan(32, 9, 128, backward, lanes=lanes).layout == "cluster"
        for h in (cap + 1, 512):
            assert lk.plan(32, 6, h, backward, lanes=lanes).layout == "grid", h
        assert lk.plan(32, 6, 1100, backward, lanes=lanes).layout == "grid"
        assert lk.plan(32, 6, STREAM_CAP + 1, backward, lanes=lanes).layout == "l2"


@pytest.mark.parametrize("backward", [False, True])
def test_plan_picks_the_grid_past_the_clusters_cap(backward):
    """Every H from past the cluster's cap up to the grid's at F = 6,
    B = 32 (H = 335 and 512 in the backward, 462 and 512 in the forward
    among them) takes the grid layout, each block holding its whole share,
    at one lane and at the fleet's 64; past that cap (H = 1,100, 1,600) the
    grid streams, and past the streamed grid's cap the weights go through
    L2.  A B = 45 scoring batch has a larger h tile and a lower cap for the
    unstreamed grid."""
    for lanes in (1, 64):
        for h in range(CLUSTER_CAP[backward] + 1, GRID_CAP[backward] + 1):
            p = lk.plan(32, 6, h, backward, lanes=lanes)
            assert p.layout == "grid" and p.mode == 0, (lanes, h)
        for h in (GRID_CAP[backward] + 1, 1100, 1600):
            p = lk.plan(32, 6, h, backward, lanes=lanes)
            assert p.layout == "grid" and p.mode in lk.STREAM_LEVELS[backward], (lanes, h)
        assert lk.plan(32, 6, STREAM_CAP + 1, backward, lanes=lanes).layout == "l2"
    for h in ((335, 512) if backward else (462, 512)):
        assert lk.plan(32, 6, h, backward).layout == "grid"
    # grid_plans yields every whole plan before the first streamed one
    cap45 = max(h for h in range(300, 1000)
                if next(lk.grid_plans(45, 6, h, backward), lk.Plan("l2", 1, 0, 1, 1)).mode == 0)
    assert cap45 < GRID_CAP[backward]
    at, past = lk.plan(45, 6, cap45, backward), lk.plan(45, 6, cap45 + 1, backward)
    assert at.layout == past.layout == "grid" and at.mode == 0
    assert past.mode in lk.STREAM_LEVELS[backward]


@pytest.mark.parametrize("backward", [False, True])
def test_grid_plans_fit_a_block_and_the_cards_capacity(backward):
    """Every grid plan, chosen or not, at several batches, widths and SM
    counts: the mirrored bytes of a block are the plan's and at most a
    block's shared memory, a block holds ceil(H / K) units of the tile's
    groups in at most 256 threads, a thread 4, 2 or 1 rows, no block is
    empty, and lanes per launch x tiles x K is within the plan's capacity,
    the card's SMs at one block an SM; a streamed plan's mode is a level
    of STREAM_LEVELS, its chunks a width of KAPPAS, and under STREAM_COLS
    its rows held F plus a multiple of kappa, below F + H.  The chosen
    plan is one of them: unstreamed where one fits, else of the least
    streaming; with the fewest tiles, then the fewest rows a thread, then
    (streamed) the widest chunks and the most rows held, then the fewest
    blocks of at most GRID_THREADS threads."""
    seen = 0
    for sms in (lk.SMS, 114):
        for batch in (1, 5, 32, 45):
            for f, h in [(6, h) for h in range(335, 1000, 37)] + [(6, 64), (9, 128), (1, 300)]:
                every = list(lk.grid_plans(batch, f, h, backward, sms))
                for p in every:
                    seen += 1
                    tile = p.groups * p.rows
                    tiles = -(-batch // tile)
                    assert p.rows in lk.GRID_ROWS
                    assert p.layout == "grid" and p.cluster == 0
                    assert p.mode in (0,) + lk.STREAM_LEVELS[backward]
                    if p.mode & lk.STREAM_COLS:
                        assert f <= p.rho < f + h and (p.rho - f) % p.kappa == 0
                    else:
                        assert p.rho == 0
                    assert p.kappa == 0 if not p.mode else p.kappa in lk.KAPPAS
                    assert p.smem == 4 * lk._grid_floats(f, h, p.blocks, tile, backward,
                                                         p.mode, p.kappa, p.rho)
                    assert p.smem <= lk.MAX_SHARED_BYTES
                    assert p.span == -(-h // p.blocks) and p.span * p.groups <= lk.L2_THREADS
                    assert (p.blocks - 1) * p.span < h
                    assert p.capacity == sms and p.per_launch >= 1
                    assert p.per_launch * tiles * p.blocks <= p.capacity
                assert len(set(every)) == len(every)
                try:
                    chosen = lk.plan(batch, f, h, backward, sms=sms, _layout="grid")
                except ValueError:
                    assert not every
                    continue
                assert chosen in every
                whole = [p for p in every if not p.mode]
                if whole:
                    every = whole
                else:
                    level = min(bin(p.mode).count("1") for p in every)
                    every = [p for p in every if bin(p.mode).count("1") == level]
                tiles = min(-(-batch // (q.groups * q.rows)) for q in every)
                top = [p for p in every if -(-batch // (p.groups * p.rows)) == tiles]
                top = [p for p in top if p.rows == min(q.rows for q in top)]
                if top[0].mode:
                    top = [p for p in top if p.kappa == max(q.kappa for q in top)]
                if top[0].mode & lk.STREAM_COLS:
                    top = [p for p in top if p.rho == max(q.rho for q in top)]
                narrow = [p for p in top if p.span * p.groups <= lk.GRID_THREADS]
                assert chosen.blocks == min(p.blocks for p in (narrow or top))
    assert seen > 1000


def test_forcing_the_grid_where_it_does_not_fit_raises():
    """Past the streamed grid's cap (at B = 32 and at B = 128), and on a
    card of 4 SMs, forcing the grid raises; so does the launcher given
    such a plan."""
    with pytest.raises(ValueError, match="grid layout"):
        lk.plan(32, 6, STREAM_CAP + 1, _layout="grid")
    with pytest.raises(ValueError, match="grid layout"):
        lk.plan(32, 6, STREAM_CAP + 1, True, _layout="grid")
    with pytest.raises(ValueError, match="grid layout"):
        lk.plan(128, 6, 1100, True, _layout="grid")
    with pytest.raises(ValueError, match="grid layout"):
        lk.plan(32, 6, 512, True, sms=4, _layout="grid")
    args = [_t(a) for a in _inputs(1, 2, 4, 6, 1100, 0)]
    with pytest.raises(ValueError, match="grid layout"):
        lk.lstm_seq_cuda(*args, _plan=lk.plan(128, 6, 2000, _layout="grid"))


def test_grid_scratch_is_an_exchange_and_zeroed_counters():
    """The grid forward's scratch: two (tile, H + 4 rounded) halves a tile
    for the lanes of one launch, and one zeroed arrival counter a tile of
    every lane; the backward takes only the counters; the other layouts
    none (the L2 layout's global state aside)."""
    x = torch.zeros(1)
    p = lk.plan(5, 6, 512)                    # a 5-row tile, 6 lanes a launch
    assert (p.layout, p.groups * p.rows, p.per_launch) == ("grid", 5, 6)
    work, sync = lk._work(x, p, 9, 5, 512, False)
    assert work.numel() == 6 * 1 * 2 * 5 * 516
    assert sync.dtype == torch.int32 and sync.numel() == 9 and not sync.any()
    q = lk.plan(5, 6, 512, True, _layout="grid")
    work, sync = lk._work(x, q, 3, 5, 512, True)
    assert work is None and sync.numel() == 3 * -(-5 // (q.groups * q.rows))
    assert lk._work(x, lk.plan(32, 6, 64), 3, 32, 64, False) == (None, None)


# the shapes the streamed grid must take at F = 6, B = 32, both directions
STREAM_SHAPES = (768, 1024, 1100, 1600, 2048)


@pytest.mark.parametrize("backward", [False, True])
def test_plan_streams_the_grid_past_its_whole_cap(backward):
    """At H = 768 (the forward still whole), 1,024, 1,100, 1,600 and 2,048
    (F = 6, B = 32) and at [4o]'s B = 45 scoring split of H = 1,100 the
    plan takes the grid with the least streaming that fits, its block
    within a block's shared memory and lanes per launch x tiles x K within
    the card's SMs; the streamed rows of the columns appear only past
    H = 1,100.  Past the streamed cap, and at B = 128 of H = 1,100, the L2
    layout, where forcing the grid raises."""
    shapes = [(32, h) for h in STREAM_SHAPES] + ([] if backward else [(45, 1100)])
    for batch, h in shapes:
        p = lk.plan(batch, 6, h, backward)
        assert p.layout == "grid", (batch, h)
        assert p.mode in ((0,) if (h, backward) == (768, False) else ()) + \
            lk.STREAM_LEVELS[backward], (batch, h)
        assert p.smem == 4 * lk._grid_floats(6, h, p.blocks, p.groups * p.rows, backward,
                                             p.mode, p.kappa, p.rho) <= lk.MAX_SHARED_BYTES
        tiles = -(-batch // (p.groups * p.rows))
        assert p.per_launch * tiles * p.blocks <= p.capacity == lk.SMS
        assert bool(p.mode & lk.STREAM_COLS) == (h > 1100 and (h, backward) != (1280, False))
        # no streaming mode that stops short of this one fits the same block
        for mode in lk.STREAM_LEVELS[backward]:
            if p.mode and mode < p.mode:
                with pytest.raises(ValueError, match="does not fit"):
                    lk.stream_plan(p, 6, h, backward, mode, p.kappa)
    for batch, h in ((32, STREAM_CAP + 1), (32, 5000), (128, 1100)):
        assert lk.plan(batch, 6, h, backward).layout == "l2"
        with pytest.raises(ValueError, match="grid layout"):
            lk.plan(batch, 6, h, backward, _layout="grid")


def _parent_grid_plan(batch, f, hidden, backward, sms=lk.SMS):
    """The grid plan this layout's first version chose (no streaming), or
    None where it had none: every shape, K and groups whose whole block
    fits, then the fewest tiles, the fewest rows a thread, the fewest
    blocks of at most GRID_THREADS threads."""
    plans = []
    for rows, blocks, hc, groups, tiles in lk._grid_shapes(batch, hidden, sms):
        smem = 4 * lk._grid_floats(f, hidden, blocks, groups * rows, backward)
        if smem <= lk.MAX_SHARED_BYTES:
            plans.append(lk.Plan("grid", groups, smem, hc, 0, 0, 0, blocks,
                                 sms // (blocks * tiles), sms, rows))
    if not plans:
        return None
    tiles = min(-(-batch // (p.groups * p.rows)) for p in plans)
    plans = [p for p in plans if -(-batch // (p.groups * p.rows)) == tiles]
    plans = [p for p in plans if p.rows == min(q.rows for q in plans)]
    narrow = [p for p in plans if p.span * p.groups <= lk.GRID_THREADS]
    return min(narrow or plans, key=lambda p: p.blocks)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [1, 5, 32, 45])
def test_plan_keeps_the_parents_plan_where_the_grid_held_it_whole(batch, backward):
    """Wherever the unstreamed grid took a shape (past the cluster, up to
    its caps, at the existing plan tests' batches, widths and lanes), the
    plan is the one it chose, with no streaming mode, kappa or rho; the
    shared-memory and cluster layouts keep theirs (their plans' code is
    unchanged, and they come first)."""
    for f, h in [(6, h) for h in range(335, 1000, 13)] + [(9, 128), (1, 300), (6, 64)]:
        for lanes in (1, 64):
            p = lk.plan(batch, f, h, backward, lanes=lanes)
            parent = _parent_grid_plan(batch, f, h, backward)
            if p.layout in ("smem", "cluster"):
                continue
            if parent is not None:
                assert p == parent and (p.mode, p.kappa, p.rho) == (0, 0, 0), (f, h, lanes)
            else:
                assert p.layout == "grid" and p.mode, (f, h, lanes)


def test_stream_plan_forces_each_mode_at_a_shape_that_needs_none():
    """At H = 512 the grid holds the whole; stream_plan gives the same
    launch geometry with each streaming mode and chunk width, the mirrored
    bytes its own, under STREAM_COLS the most rows held (or those asked
    for), and refuses modes the direction lacks, bad widths and rows."""
    for backward in (False, True):
        base = lk.plan(32, 6, 512, backward)
        assert base.layout == "grid" and base.mode == 0
        for mode in lk.STREAM_LEVELS[backward]:
            for kappa in lk.KAPPAS:
                q = lk.stream_plan(base, 6, 512, backward, mode, kappa)
                assert q[:4] == base[:4] or q.smem != base.smem
                assert (q.groups, q.blocks, q.rows, q.per_launch) == (
                    base.groups, base.blocks, base.rows, base.per_launch)
                assert (q.mode, q.kappa) == (mode, kappa)
                assert q.smem == 4 * lk._grid_floats(6, 512, q.blocks, q.groups * q.rows,
                                                     backward, mode, kappa, q.rho)
                if mode & lk.STREAM_COLS:
                    # all of H fits: every chunk but the last held
                    assert q.rho == 6 + kappa * (511 // kappa)
                    low = lk.stream_plan(base, 6, 512, backward, mode, kappa, rho=6)
                    assert low.rho == 6 and low.smem < q.smem
                else:
                    assert q.rho == 0
        with pytest.raises(ValueError, match="STREAM|one of"):
            lk.stream_plan(base, 6, 512, backward, lk.STREAM_COLS)
        with pytest.raises(ValueError, match="kappa"):
            lk.stream_plan(base, 6, 512, backward, lk.STREAM_H, 30)
        with pytest.raises(ValueError, match="rho"):
            lk.stream_plan(base, 6, 512, backward, lk.STREAM_LEVELS[backward][-1], 64, rho=7)
    with pytest.raises(ValueError, match="one of"):
        lk.stream_plan(lk.plan(32, 6, 512), 6, 512, False, lk.STREAM_H | lk.STREAM_WH)
    with pytest.raises(ValueError, match="grid plan"):
        lk.stream_plan(lk.plan(32, 6, 64), 6, 64, False, lk.STREAM_H)


def test_streamed_scratch_adds_the_packed_copy():
    """Under STREAM_COLS the scratch holds, past the forward's exchange
    (the backward's: from its start), (F + H - rho) x Hc float4s for each
    block of a launch's lanes; without it a streamed launch's scratch is
    the unstreamed one's."""
    x = torch.zeros(1, 1, 1, 6)
    for backward in (False, True):
        p = lk.plan(32, 6, 1600, backward)
        assert p.mode & lk.STREAM_COLS and p.per_launch == 1
        work, sync = lk._work(x, p, 3, 32, 1600, backward)
        packed = p.blocks * (6 + 1600 - p.rho) * 4 * p.span
        exchange = 0 if backward else 2 * p.groups * p.rows * (1600 + 4)
        assert work.numel() == exchange + packed and sync.numel() == 3 and not sync.any()
    q = lk.plan(32, 6, 1100, True)
    assert q.mode == lk.STREAM_H | lk.STREAM_WH
    assert lk._work(x, q, 2, 32, 1100, True)[0] is None
    r = lk.plan(32, 6, 1100)
    assert lk._work(x, r, 2, 32, 1100, False)[0].numel() == 2 * r.groups * r.rows * 1104


def test_plan_sizes_the_cluster_by_the_cards_sms():
    """The smallest cluster that fits, doubled while lanes x tiles x C is
    under the 132 SMs: the hidden=128 world's fleet fit (64 lanes) takes
    C = 2 forward and C = 4 backward (its dgates tile in shared memory),
    one lane C = 16; one lane at H = 256 C = 16, the backward's dgates tile
    kept in shared memory at half the groups.  At the card test's B = 37
    (top 10 groups) the dgates stay in shared memory at H = 192 and go
    through the output from H = 256 up to the cap."""
    fwd, bwd = lk.plan(32, 6, 128, lanes=64), lk.plan(32, 6, 128, True, lanes=64)
    assert (fwd.cluster, fwd.groups, fwd.smem) == (2, 4, 155_392)
    assert (bwd.cluster, bwd.groups, bwd.mode, bwd.smem) == (4, 8, 0, 217_344)
    assert lk.plan(32, 6, 128).cluster == lk.plan(32, 6, 128, True).cluster == 16
    one = lk.plan(32, 6, 256, True)
    assert (one.cluster, one.groups, one.mode) == (16, 4, 0)
    assert lk.plan(32, 6, 256, lanes=64).cluster == 8
    for h in (256, 300, CLUSTER_CAP[True]):
        assert lk.plan(37, 6, h, True, lanes=2).mode == lk.DGATES_OUT
    assert lk.plan(37, 6, 192, True, lanes=2).mode == 0
    # a card with twice the SMs doubles the fleet fit's clusters once more;
    # off the card a plan assumes an H100 SXM's 132
    assert lk.plan(32, 6, 128, lanes=64, sms=2 * lk.SMS).cluster == 8
    assert lk.device_sms(torch.device("cpu")) == lk.SMS == 132


@pytest.mark.parametrize("backward", [False, True])
def test_cluster_plans_fit_a_block_and_tile_the_grid(backward):
    """Every cluster plan, chosen or forced at each size: the mirrored
    bytes of a block are the plan's and at most a block's shared memory,
    C is 2, 4, 8 or 16, a block holds ceil(H / C) units of the tile's
    groups, and the grid's x (C blocks a batch tile) is a multiple of C."""
    seen = 0
    for batch in (1, 5, 32, 45):
        for f, h in [(6, h) for h in range(115, 460, 7)] + [(9, 128), (1, 300), (142, 64)]:
            for cluster in (None,) + lk.CLUSTERS:
                try:
                    p = lk.plan(batch, f, h, backward, lanes=3, _layout="cluster",
                                _cluster=cluster)
                except ValueError:
                    assert cluster is not None or h > CLUSTER_CAP[backward]
                    continue
                seen += 1
                tile = p.groups * lk.ROWS
                assert p.layout == "cluster" and p.cluster in lk.CLUSTERS
                assert cluster in (None, p.cluster)
                assert p.smem == 4 * lk._cluster_floats(f, h, p.cluster, tile, backward, p.mode)
                assert p.smem <= lk.MAX_SHARED_BYTES
                assert p.span == -(-h // p.cluster) and p.span * p.groups <= lk.L2_THREADS
                assert p.mode in ((0, lk.DGATES_OUT) if backward else (0,))
                grid_x = p.cluster * -(-batch // tile)
                assert grid_x % p.cluster == 0 and grid_x // p.cluster * tile >= batch
                every = list(lk.cluster_plans(batch, f, h, p.cluster, backward))
                assert every[0] == p and len(set(every)) == len(every)
                assert all(q.smem <= lk.MAX_SHARED_BYTES and q.span * q.groups <= lk.L2_THREADS
                           for q in every)
    assert seen > 300


def test_forcing_the_cluster_where_it_does_not_fit_raises():
    with pytest.raises(ValueError, match="cluster"):
        lk.plan(32, 6, 512, True, _layout="cluster")
    with pytest.raises(ValueError, match="cluster"):
        lk.plan(32, 6, 1100, _layout="cluster")
    with pytest.raises(ValueError, match="cluster of 2"):
        lk.plan(32, 6, 256, _cluster=2)
    with pytest.raises(ValueError, match="one of"):
        lk.plan(32, 6, 128, _cluster=3)
    with pytest.raises(ValueError, match="one of"):
        lk.plan(32, 6, 128, _layout="l2", _cluster=4)
    args = [_t(a) for a in _inputs(1, 2, 4, 6, 512, 0)]
    with pytest.raises(ValueError, match="cluster"):
        lk.lstm_seq_cuda(*args, _plan=lk.plan(4, 6, 512, _layout="cluster"))


def _card_inputs(lanes, t, b, f, h, seed):
    dev = torch.device("cuda")
    args = [_t(a).to(dev) for a in _inputs(lanes, t, b, f, h, seed)]
    g = torch.Generator().manual_seed(seed + 1)
    dh, dc = (torch.randn((lanes, b, h), generator=g).to(dev) for _ in range(2))
    return args, dh, dc


def _run_pair(args, dh, dc, **force):
    """Every output of the pair as int32 bits: h_seq, c_seq, dgates, dh0,
    dc0; ``force`` (``_layout``, ``_cluster``) goes to each launch's plan."""
    lanes, _, b, f = args[0].shape
    h = args[1].shape[-1]
    fwd, bwd = (lk.plan(b, f, h, backward, lanes=lanes, **force) for backward in (False, True))
    hs, cs = lk.lstm_seq_cuda(*args, save=True, _plan=fwd)
    back = lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc, _plan=bwd)
    return [o.view(torch.int32) for o in (hs, cs, *back)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,t,b,f,h", [(2, 8, 32, 6, 64), (1, 4, 5, 6, 112)])
def test_the_cluster_layout_equals_the_shared_memory_one_on_the_card(lanes, t, b, f, h):
    """On shapes one block holds, the cluster layout forced at each size
    gives the shared-memory layout's bits: every saved state, dgates, dh0,
    dc0; and it counts as a cluster launch."""
    _need_card()
    args, dh, dc = _card_inputs(lanes, t, b, f, h, 43)
    want = _run_pair(args, dh, dc, _layout="smem")
    for cluster in lk.CLUSTERS:
        before = kernels.layout_counts()
        got = _run_pair(args, dh, dc, _layout="cluster", _cluster=cluster)
        torch.cuda.synchronize()
        after = kernels.layout_counts()
        assert after["lstm_cell_cluster"] == before["lstm_cell_cluster"] + 1
        assert after["lstm_cell_bwd_cluster"] == before["lstm_cell_bwd_cluster"] + 1
        for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
            assert torch.equal(a, c), (cluster, name)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [128, 192, 256, CLUSTER_CAP[True]])
def test_the_cluster_layout_equals_the_l2_one_and_the_twins_on_the_card(h):
    """Past one block: the planned cluster (and the cluster at each size
    that fits; dgates published in shared memory at H = 192, through the
    output from H = 256) gives the forced
    L2 layout's bits, at a ragged batch of two tiles; and both match the
    twins within the pair's limits (forward 1e-5, backward 1e-4 of the
    largest value)."""
    _need_card()
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref

    lanes, t, b, f = 2, 4, 37, 6
    args, dh, dc = _card_inputs(lanes, t, b, f, h, h)
    want = _run_pair(args, dh, dc, _layout="l2")
    assert lk.plan(b, f, h, True, lanes=lanes).layout == "cluster"
    for cluster in (None,) + lk.CLUSTERS:
        try:
            lk.plan(b, f, h, True, lanes=lanes, _layout="cluster", _cluster=cluster)
        except ValueError:
            continue
        got = _run_pair(args, dh, dc, _layout="cluster", _cluster=cluster)
        torch.cuda.synchronize()
        for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
            assert torch.equal(a, c), (cluster, name)
    hs, cs = (o.view(torch.float32) for o in want[:2])
    hr, cr = lstm_seq_ref(*args)
    torch.testing.assert_close(hs, hr, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, cr, rtol=0, atol=1e-5)
    ref = lstm_seq_backward_ref(args[0], hs, cs, *args[3:], dh, dc)
    for name, got, w in zip(("dgates", "dh0", "dc0"), want[2:], ref):
        got = got.view(torch.float32)
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


def _fma32(a, b, c):
    """fmaf(a, b, c) of fp32 arrays, exactly: the product in float64 is
    exact, TwoSum gives the sum's error, and a float64 sum that lands on a
    midpoint of two fp32 values is moved to the side the error points to."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    up = np.nextafter(r, np.float32(np.inf))
    down = np.nextafter(r, np.float32(-np.inf))
    r64 = r.astype(np.float64)
    to_up = (s == (r64 + up.astype(np.float64)) / 2) & (err > 0)
    to_down = (s == (r64 + down.astype(np.float64)) / 2) & (err < 0)
    return np.where(to_up, up, np.where(to_down, down, r))


@pytest.mark.cuda
@pytest.mark.parametrize("h,layout", [(512, "l2"), (512, "grid"), (1100, "grid"),
                                      (128, "cluster"), (64, "smem")])
def test_dh0_is_the_ascending_fma_sum_on_the_card(h, layout):
    """dh0[b, j] = sum over the 4H gate columns of dgates[0, b, col] wh[j, col],
    each term an fmaf in ascending column order, bit for bit in every
    layout (the planned one, L2 forced at H = 512): the L2 backward reads
    wh through its stage in shared memory, the grid backward the dgates
    other blocks wrote through its stage (at H = 1,100 streamed, rows J_q
    of wh beside them), and both keep that order."""
    _need_card()
    lanes, t, b, f = 1, 2, 5, 6
    args, dh, dc = _card_inputs(lanes, t, b, f, h, 7)
    force = dict(_layout=layout) if (h, layout) == (512, "l2") else {}
    assert lk.plan(b, f, h, True, **force).layout == layout
    hs, cs = lk.lstm_seq_cuda(*args, save=True)
    dgates, dh0, _ = lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc,
                                               _plan=lk.plan(b, f, h, True, **force))
    torch.cuda.synchronize()
    d = dgates[0, 0].cpu().numpy()
    w = args[4][0].cpu().numpy()
    acc = np.zeros((b, h), np.float32)
    for col in range(4 * h):
        acc = _fma32(d[:, col, None], w[None, :, col], acc)
    assert np.array_equal(dh0[0].cpu().numpy().view(np.int32), acc.view(np.int32))


@pytest.mark.cuda
def test_the_cluster_layout_takes_more_than_65535_lanes_on_the_card():
    """65,537 lanes at a small shape, the cluster layout forced: two
    launches' worth of lanes on gridDim.y, the shared-memory layout's bits."""
    _need_card()
    args, dh, dc = _card_inputs(65_537, 2, 3, 2, 5, 11)
    want = _run_pair(args, dh, dc, _layout="smem")
    got = _run_pair(args, dh, dc, _layout="cluster", _cluster=2)
    torch.cuda.synchronize()
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), name


def _grid_pair(args, dh, dc, backward_too=True, **force):
    """The pair's outputs as int32 bits with each launch's plan forced by
    ``force``; the backward only where ``backward_too``."""
    lanes, _, b, f = args[0].shape
    h = args[1].shape[-1]
    fwd = lk.plan(b, f, h, False, lanes=lanes, **force)
    hs, cs = lk.lstm_seq_cuda(*args, save=True, _plan=fwd)
    out = [hs, cs]
    if backward_too:
        bwd = lk.plan(b, f, h, True, lanes=lanes, **force)
        out += lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc, _plan=bwd)
    return [o.view(torch.int32) for o in out]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [335, 462, 512, GRID_CAP[True], GRID_CAP[False]])
def test_the_grid_layout_equals_the_l2_one_and_the_twins_on_the_card(h):
    """Past the cluster's cap (and at H = 335 forced in the forward, which
    the cluster holds): the grid layout gives the forced L2 layout's bits,
    every saved state, dgates, dh0 and dc0 (the backward where it fits,
    up to its cap), at the batch its caps are for; it counts as a grid
    launch, and both match the twins within the pair's limits (forward
    1e-5, backward 1e-4 of the largest value)."""
    _need_card()
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref

    lanes, t, b, f = 1, 4, 32, 6
    args, dh, dc = _card_inputs(lanes, t, b, f, h, h)
    back = h <= GRID_CAP[True]
    want = _grid_pair(args, dh, dc, back, _layout="l2")
    before = kernels.layout_counts()
    got = _grid_pair(args, dh, dc, back, _layout="grid")
    torch.cuda.synchronize()
    after = kernels.layout_counts()
    assert after["lstm_cell_grid"] == before["lstm_cell_grid"] + 1
    assert after["lstm_cell_bwd_grid"] == before["lstm_cell_bwd_grid"] + back
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), name
    hs, cs = (o.view(torch.float32) for o in got[:2])
    hr, cr = lstm_seq_ref(*args)
    torch.testing.assert_close(hs, hr, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, cr, rtol=0, atol=1e-5)
    if back:
        ref = lstm_seq_backward_ref(args[0], hs, cs, *args[3:], dh, dc)
        for name, g, w in zip(("dgates", "dh0", "dc0"), got[2:], ref):
            g = g.view(torch.float32)
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("h", [768, 1024, 1100, 1600])
def test_the_streamed_grid_equals_the_l2_one_and_the_twins_on_the_card(h):
    """Past the unstreamed grid's cap: the planned grid (streaming the h
    tile, the backward's rows of wh, past H = 1,100 the rows of the
    columns) gives the forced L2 layout's bits, every saved state, dgates,
    dh0 and dc0, at B = 32, T = 4; it counts as a grid launch each way, and
    both match the twins within the pair's limits (forward 1e-5, backward
    1e-4 of the largest value)."""
    _need_card()
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref

    lanes, t, b, f = 1, 4, 32, 6
    args, dh, dc = _card_inputs(lanes, t, b, f, h, h)
    assert lk.plan(b, f, h, True).mode in lk.STREAM_LEVELS[True]
    want = _grid_pair(args, dh, dc, _layout="l2")
    before = kernels.layout_counts()
    got = _grid_pair(args, dh, dc)
    torch.cuda.synchronize()
    after = kernels.layout_counts()
    assert after["lstm_cell_grid"] == before["lstm_cell_grid"] + 1
    assert after["lstm_cell_bwd_grid"] == before["lstm_cell_bwd_grid"] + 1
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), (h, name)
    hs, cs = (o.view(torch.float32) for o in got[:2])
    hr, cr = lstm_seq_ref(*args)
    torch.testing.assert_close(hs, hr, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, cr, rtol=0, atol=1e-5)
    ref = lstm_seq_backward_ref(args[0], hs, cs, *args[3:], dh, dc)
    for name, g, w in zip(("dgates", "dh0", "dc0"), got[2:], ref):
        g = g.view(torch.float32)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 37])
def test_each_streaming_mode_equals_the_whole_grid_on_the_card(b):
    """At H = 512, which the grid holds whole: each streaming mode forced
    (every chunk width; under STREAM_COLS with the most rows held and with
    only the x rows held) gives today's grid bits, forward and backward, at
    B = 32 and at a ragged B = 37."""
    _need_card()
    lanes, t, f, h = 1, 3, 6, 512
    args, dh, dc = _card_inputs(lanes, t, b, f, h, 19)
    fwd, bwd = (lk.plan(b, f, h, backward) for backward in (False, True))
    assert fwd.mode == bwd.mode == 0
    hs, cs = lk.lstm_seq_cuda(*args, save=True, _plan=fwd)
    want = [o.view(torch.int32) for o in (hs, cs, *lk.lstm_seq_backward_cuda(
        args[0], hs, cs, *args[3:], dh, dc, _plan=bwd))]
    for backward, base in ((False, fwd), (True, bwd)):
        for mode in lk.STREAM_LEVELS[backward]:
            for kappa in lk.KAPPAS:
                for rho in ((None, f) if mode & lk.STREAM_COLS else (None,)):
                    q = lk.stream_plan(base, f, h, backward, mode, kappa, rho)
                    if backward:
                        got = lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc,
                                                        _plan=q)
                        names, wants = ("dgates", "dh0", "dc0"), want[2:]
                    else:
                        got = lk.lstm_seq_cuda(*args, save=True, _plan=q)
                        names, wants = ("h_seq", "c_seq"), want[:2]
                    torch.cuda.synchronize()
                    for name, a, c in zip(names, got, wants):
                        assert torch.equal(a.view(torch.int32), c), (mode, kappa, rho, name)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1100, 1600])
def test_the_streamed_grid_takes_more_lanes_than_one_launch_holds_on_the_card(h):
    """Three lanes at H = 1,100 and 1,600 (the latter streaming the rows of
    the columns from each launch's packed copy), B = 32, T = 3: one lane a
    launch, three cooperative launches each way; the forced L2 layout's
    bits."""
    _need_card()
    args, dh, dc = _card_inputs(3, 3, 32, 6, h, 23)
    for backward in (False, True):
        p = lk.plan(32, 6, h, backward, lanes=3)
        assert p.per_launch == 1 and p.mode
    want = _grid_pair(args, dh, dc, _layout="l2")
    got = _grid_pair(args, dh, dc)
    torch.cuda.synchronize()
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), (h, name)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,t,b,f,h,other", [(2, 8, 32, 6, 64, "smem"),
                                                 (1, 4, 37, 6, 256, "cluster")])
def test_the_grid_layout_equals_the_first_layouts_on_the_card(lanes, t, b, f, h, other):
    """On shapes one block or a cluster holds, the grid layout (forced)
    gives their bits: the shared-memory layout's at H = 64, the cluster's
    at H = 256 (a ragged batch of two tiles in the cluster)."""
    _need_card()
    args, dh, dc = _card_inputs(lanes, t, b, f, h, 47)
    want = _grid_pair(args, dh, dc, _layout=other)
    got = _grid_pair(args, dh, dc, _layout="grid")
    torch.cuda.synchronize()
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("rows", lk.GRID_ROWS)
def test_every_grid_row_count_gives_the_same_bits_on_the_card(rows):
    """The grid kernels with 4, 2 or 1 batch rows a thread (the largest
    tile, the fewest blocks that fit) at a ragged batch: the forced L2
    layout's bits, forward and backward, and each a grid launch."""
    _need_card()
    lanes, t, b, f, h = 1, 3, 37, 6, 512
    args, dh, dc = _card_inputs(lanes, t, b, f, h, 17)
    want = _grid_pair(args, dh, dc, _layout="l2")
    plans = []
    for backward in (False, True):
        every = [p for p in lk.grid_plans(b, f, h, backward) if p.rows == rows]
        tile = max(p.groups * p.rows for p in every)
        plans.append(min((p for p in every if p.groups * p.rows == tile),
                         key=lambda p: p.blocks))
    before = kernels.layout_counts()
    hs, cs = lk.lstm_seq_cuda(*args, save=True, _plan=plans[0])
    back = lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc, _plan=plans[1])
    torch.cuda.synchronize()
    after = kernels.layout_counts()
    assert after["lstm_cell_grid"] == before["lstm_cell_grid"] + 1
    assert after["lstm_cell_bwd_grid"] == before["lstm_cell_bwd_grid"] + 1
    got = [o.view(torch.int32) for o in (hs, cs, *back)]
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), (rows, name)


@pytest.mark.cuda
def test_the_grid_layout_takes_more_lanes_than_one_launch_holds_on_the_card():
    """Five lanes at H = 512, B = 32, T = 3: one lane a launch (K = 128 of
    the card's 132 SMs) takes five cooperative launches each way; the
    forced L2 layout's bits."""
    _need_card()
    args, dh, dc = _card_inputs(5, 3, 32, 6, 512, 13)
    assert lk.plan(32, 6, 512, lanes=5).per_launch == 1
    assert lk.plan(32, 6, 512, True, lanes=5).per_launch == 1
    want = _grid_pair(args, dh, dc, _layout="l2")
    got = _grid_pair(args, dh, dc)
    torch.cuda.synchronize()
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), got, want):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,t,b,f,h", [(2, 8, 32, 6, 64), (1, 4, 5, 6, 112),
                                           (3, 3, 33, 5, 40)])
def test_the_two_layouts_agree_bit_for_bit_on_the_card(lanes, t, b, f, h):
    """On shapes the shared-memory layout holds, the weights-through-L2
    layout (forced) gives its bits: every saved state, dgates, dh0, dc0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    args = [_t(a).to(dev) for a in _inputs(lanes, t, b, f, h, 41)]
    g = torch.Generator().manual_seed(2)
    dh, dc = (torch.randn((lanes, b, h), generator=g).to(dev) for _ in range(2))
    outs = {}
    for layout in ("smem", "l2"):
        fwd, bwd = (lk.plan(b, f, h, backward, lanes=lanes, _layout=layout)
                    for backward in (False, True))
        assert fwd.layout == bwd.layout == layout
        hs, cs = lk.lstm_seq_cuda(*args, save=True, _plan=fwd)
        back = lk.lstm_seq_backward_cuda(args[0], hs, cs, *args[3:], dh, dc, _plan=bwd)
        outs[layout] = [o.view(torch.int32) for o in (hs, cs, *back)]
    torch.cuda.synchronize()
    for name, a, c in zip(("h_seq", "c_seq", "dgates", "dh0", "dc0"), *outs.values()):
        assert torch.equal(a, c), name


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
