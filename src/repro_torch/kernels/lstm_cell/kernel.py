"""Launchers of the whole-sequence LSTM kernels (``csrc/lstm_cell.cu``).

:func:`lstm_seq_cuda` runs T steps of the cell in one launch and
:func:`lstm_seq_backward_cuda` walks them back in another.  The one-step
op :func:`lstm_cell_cuda`, which replaces
``repro.kernels.lstm_cell.kernel.lstm_cell_pallas``, is the forward at
T = 1.  Every input carries a leading lane axis (the fleet's lanes train
different params in one launch) and may have any lane stride.
``launches`` counts forward launches, ``bwd_launches`` backward ones, in
any layout; ``cluster_launches``/``cluster_bwd_launches``,
``grid_launches``/``grid_bwd_launches`` and ``l2_launches``/
``l2_bwd_launches`` count those that ran a lane's weights across a
thread-block cluster, across the whole card or read them through L2.

:func:`plan` sizes a launch for any F >= 1 and H >= 1: the weights in a
block's shared memory where they fit (with fewer batch-row groups if need
be), else spread over the shared memory of a cluster of 2-16 blocks, else
over K blocks of the whole card in one cooperative launch (streaming
through a ring in shared memory what a block cannot hold: the h tile, then
the backward's rows of wh, then the rows of its columns past the first
rho), else read from global memory through L2.  The launchers call it
before they look at the device, so their checks show on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_args, current_stream

launches = 0
bwd_launches = 0
cluster_launches = 0
cluster_bwd_launches = 0
grid_launches = 0
grid_bwd_launches = 0
l2_launches = 0
l2_bwd_launches = 0

MAX_SHARED_BYTES = 232_448   # dynamic shared memory of one H100 block (227 KB)
ROWS = 4                     # batch rows a thread owns (kRows in the source)
THREADS = 256                # threads a block aims at: H x groups
MAX_THREADS = 1024           # threads of a block
L2_THREADS = 256             # threads of a weights-through-L2 block (kL2Threads)
MAX_GRID_Y = 65_535          # lanes of one launch (kMaxGridY): more go in further launches
LAYOUTS = ("smem", "cluster", "grid", "l2")
# kLayoutSmem, kLayoutL2, kLayoutCluster, kLayoutGrid
_LAYOUT_CODES = {"smem": 0, "l2": 1, "cluster": 2, "grid": 3}
# the l2 layout's modes (kStateGlobal, kDgatesOut); the cluster's backward
# takes DGATES_OUT too
STATE_GLOBAL, DGATES_OUT = 1, 2
CLUSTERS = (2, 4, 8, 16)     # blocks of a cluster (16: non-portable, allowed on an H100)
SMS = 132                    # streaming multiprocessors of an H100 SXM (plans off the card)
WH_COLS = 32                 # columns of wh a stage of the L2 backward's dh holds (kWhCols)
DG_COLS = 128                # columns of dgates a stage of the grid backward's dh holds (kDgCols)
# threads a grid block aims at: 4 warps at one block an SM, one a
# scheduler; fewer blocks than that read the h tile fewer times, and more
# threads a block hid no more latency (kernel_bench.py --lstm-plans)
GRID_THREADS = 128

GRID_ROWS = (4, 2, 1)        # batch rows a thread of a grid block owns (the kernel's R)
# the grid layout's streaming modes (kStreamH, kStreamWh, kStreamCols): the
# h tile through the ring, kappa columns a chunk; the backward's rows J_q
# of wh beside each dgates chunk; the rows of the block's columns from rho
# on, from a packed copy in the scratch buffer
STREAM_H, STREAM_WH, STREAM_COLS = 4, 8, 16
# the modes the plan tries, least streaming first (forward, backward)
STREAM_LEVELS = {False: (STREAM_H, STREAM_H | STREAM_COLS),
                 True: (STREAM_H, STREAM_H | STREAM_WH, STREAM_H | STREAM_WH | STREAM_COLS)}
RING = 3                     # stages of the ring (kRing)
# columns of h a chunk of the ring holds: the widths grid_plans offers, the
# plan taking the widest that fits (on an H100 at one lane of (32, 6, 1100,
# 32) every streamed plan's time fell with a wider chunk at the same K:
# kernel_bench.py --lstm-plans), and stream_plan's default
KAPPAS = (128, 64, 32)
KAPPA = KAPPAS[0]

_FWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 23 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
_fwd = _build.CFunction("lstm_seq_fwd_launch", _FWD_ARGTYPES)
_bwd = _build.CFunction("lstm_seq_bwd_launch", _BWD_ARGTYPES)
_INT_MAX = 2 ** 31 - 1


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _shared_bytes(f: int, hidden: int, tile: int, backward: bool) -> int:
    """Dynamic shared memory of one block of the shared-memory layout, as
    the source lays it out: the lane's [wx; wh] at a row stride of 4H + 1
    floats, b, the h tile (two in the forward), and in the backward the
    (tile, 4H) dgates tile."""
    weights = _round4((f + hidden) * (4 * hidden + 1))
    h_tiles = (1 if backward else 2) * tile * _round4(hidden)
    dgates = tile * 4 * hidden if backward else 0
    return 4 * (weights + 4 * hidden + h_tiles + dgates)


def _state_floats(hidden: int, tile: int, backward: bool, mode: int) -> int:
    """A block's state in the weights-through-L2 layout (``state_layout``
    of the source): the forward's two h tiles and c, the backward's h
    tile, dh, dc and, unless ``DGATES_OUT``, its (tile, 4H) dgates tile."""
    dgates = tile * 4 * hidden if backward and not mode & DGATES_OUT else 0
    return 3 * tile * _round4(hidden) + dgates


def _l2_stage_floats(span: int) -> int:
    """The L2 backward's stage of wh in shared memory (``l2_stage_floats``
    of the source): two halves of ``span`` rows of ``WH_COLS`` columns at
    row stride ``WH_COLS + 1``."""
    return 2 * span * (WH_COLS + 1)


def _cluster_floats(f: int, hidden: int, cluster: int, tile: int, backward: bool,
                    mode: int = 0) -> int:
    """Dynamic shared memory (floats) of one block of the cluster layout
    (``cluster_layout`` of the source): its Hc = ceil(H / C) units' four
    gate columns of [wx; wh] (a float4 a unit and row) and their bias, the
    tile's h over all H units and its x_t (two of each in the forward), and
    in the backward rows J_q of wh and, unless ``DGATES_OUT``, the (tile,
    4H) dgates tile."""
    hc = -(-hidden // cluster)
    columns = (f + hidden + 1) * 4 * hc
    tiles = (1 if backward else 2) * (tile * _round4(hidden) + _round4(tile * f))
    rows = hc * 4 * hidden if backward else 0
    dgates = tile * 4 * hidden if backward and not mode & DGATES_OUT else 0
    return columns + tiles + rows + dgates


def _grid_floats(f: int, hidden: int, blocks: int, tile: int, backward: bool, mode: int = 0,
                 kappa: int = 0, rho: int = 0) -> int:
    """Dynamic shared memory (floats) of one block of the grid layout
    (``grid_layout`` of the source): its Hc = ceil(H / K) units' columns
    (under ``STREAM_COLS`` only rows [0, rho) of them) and bias as in the
    cluster layout, the tile's h over all H units at row stride
    ``_round4(H) + 4`` (under ``STREAM_H`` the ring's ``RING`` stages of
    ``kappa`` columns at row stride kappa + 4), its x_t (two in the
    forward), in the backward rows J_q of wh (not under ``STREAM_WH``) and
    the two halves of the dgates stage (tile rows of ``DG_COLS + 4``, and
    under ``STREAM_WH`` Hc rows of wh beside them), and under
    ``STREAM_COLS`` the ring's stages of kappa streamed rows and its
    mbarriers."""
    hc = -(-hidden // blocks)
    streamed = mode & STREAM_H
    wh_rows = backward and mode & STREAM_WH
    cols = mode & STREAM_COLS
    columns = ((rho if cols else f + hidden) + 1) * 4 * hc
    h_tile = RING * tile * (kappa + 4) if streamed else tile * (_round4(hidden) + 4)
    x_tiles = (1 if backward else 2) * _round4(tile * f)
    rows = hc * 4 * hidden if backward and not wh_rows else 0
    stage = 2 * (tile + (hc if wh_rows else 0)) * (DG_COLS + 4) if backward else 0
    ring = RING * kappa * 4 * hc + _round4(2 * RING) if cols else 0
    return columns + h_tile + x_tiles + rows + stage + ring


class Plan(NamedTuple):
    """One launch's layout: ``"smem"`` (a block of ``hidden * groups``
    threads holds the lane's weights in shared memory), ``"cluster"``
    (``cluster`` blocks of ``span * groups`` threads, span = ceil(H / C),
    each hold their units' columns in ``smem`` bytes; under ``DGATES_OUT``
    the backward's dgates go through its output), ``"grid"`` (``blocks``
    blocks a batch tile, K, of ``span * groups`` threads, span = ceil(H /
    K), each hold their units' columns in ``smem`` bytes, in cooperative
    launches of ``per_launch`` lanes: per_launch x tiles x K blocks within
    ``capacity``, the blocks the card keeps resident at once; ``mode`` 0,
    or a level of ``STREAM_LEVELS``: the h tile through a ring of
    ``kappa``-column chunks, the backward's rows of wh beside its dgates,
    the rows of the columns from ``rho`` on from a packed copy) or ``"l2"``
    (a block of ``span * groups`` threads reads them through L2, its state
    in ``smem`` bytes of shared memory or, with ``STATE_GLOBAL`` in
    ``mode``, ``state`` floats a block of a scratch buffer).  The batch tile
    is ``groups * rows`` rows: a thread owns ``rows`` of them (``ROWS``
    but in the grid layout, whose threads own 4, 2 or 1)."""
    layout: str
    groups: int
    smem: int
    span: int
    mode: int = 0
    state: int = 0
    cluster: int = 0
    blocks: int = 0
    per_launch: int = 0
    capacity: int = 0
    rows: int = ROWS
    kappa: int = 0
    rho: int = 0


def _groups(batch: int, width: int) -> int:
    return max(1, min(THREADS // width, -(-batch // ROWS)))


def cluster_plans(batch: int, f: int, hidden: int, cluster: int, backward: bool):
    """Yields every :class:`Plan` of a cluster of ``cluster`` blocks that fits at
    (B, F, H), in the plan's order of preference: the most batch-row groups
    first; the backward keeps its dgates tile in shared memory down to half
    the groups before it publishes them through the output (on an H100 at
    one lane of H = 256, C = 16: a 16-row tile in shared memory 0.88 ms, a
    32-row tile through the output 1.22 ms, ``kernel_bench.py
    --lstm-plans``), and takes fewer groups in shared memory only after
    that."""
    hc = -(-hidden // cluster)
    if hc > L2_THREADS:
        return
    top = _groups(batch, hc)
    half = (top + 1) // 2
    order = [(g, 0) for g in range(top, half - 1, -1)]
    if backward:
        order += [(g, DGATES_OUT) for g in range(top, 0, -1)]
    order += [(g, 0) for g in range(half - 1, 0, -1)]
    for groups, mode in order:
        smem = 4 * _cluster_floats(f, hidden, cluster, groups * ROWS, backward, mode)
        if smem <= MAX_SHARED_BYTES:
            yield Plan("cluster", groups, smem, hc, mode, 0, cluster)


def _cluster_plan(batch: int, f: int, hidden: int, backward: bool, lanes: int, sms: int,
                  cluster: Optional[int]) -> Optional[Plan]:
    """The smallest cluster that fits, doubled while the launch's blocks
    (lanes x tiles x C) would leave most of the card's ``sms`` SMs idle and
    the next size fits; ``cluster`` forces a size."""
    sizes = (cluster,) if cluster else CLUSTERS
    fits = {}
    for c in sizes:
        first = next(cluster_plans(batch, f, hidden, c, backward), None)
        if first is not None:
            fits[c] = first
    fitting = list(fits)
    if not fitting:
        return None
    i = 0
    while (i + 1 < len(fitting) and fitting[i + 1] == 2 * fitting[i]
           and lanes * -(-batch // (fits[fitting[i]].groups * ROWS)) * fitting[i] < sms):
        i += 1
    return fits[fitting[i]]


def _grid_shapes(batch: int, hidden: int, sms: int):
    """(rows, K, Hc, groups, tiles) of the grid layout at (B, H) on a card
    of ``sms`` SMs: for each count of rows a thread owns (``GRID_ROWS``),
    each K = ceil(H / Hc) from the fewest blocks (Hc up to ``L2_THREADS``)
    to the most, each with the most batch-row groups (at most
    ``L2_THREADS`` threads a block) down to 1 whose K x tiles blocks fit
    the capacity the plan counts on, one block an SM (one fits wherever its
    shared memory does: at most 256 threads of at most 255 registers)."""
    for rows in GRID_ROWS:
        seen = set()
        for want in range(min(hidden, L2_THREADS), 0, -1):
            blocks = -(-hidden // want)
            if blocks in seen:
                continue
            seen.add(blocks)
            hc = -(-hidden // blocks)
            top = max(1, min(L2_THREADS // hc, -(-batch // rows)))
            for groups in range(top, 0, -1):
                tiles = -(-batch // (groups * rows))
                if blocks * tiles > sms:
                    break
                yield rows, blocks, hc, groups, tiles


def _streamed(f: int, hidden: int, blocks: int, tile: int, backward: bool, mode: int,
              kappa: int, rho: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(smem bytes, rho) of a grid block under the streaming ``mode`` with
    chunks of ``kappa`` columns, or None where it does not fit
    ``MAX_SHARED_BYTES``.  Under ``STREAM_COLS`` the block holds rows [0,
    rho) of its columns: ``rho`` where given (F plus a multiple of kappa,
    below F + H), else the most that fit; else rho is 0."""
    if not mode & STREAM_COLS:
        smem = 4 * _grid_floats(f, hidden, blocks, tile, backward, mode, kappa)
        return (smem, 0) if smem <= MAX_SHARED_BYTES else None
    hc = -(-hidden // blocks)
    if rho is None:
        room = MAX_SHARED_BYTES // 4 - _grid_floats(f, hidden, blocks, tile, backward, mode,
                                                    kappa, f)
        if room < 0:
            return None
        rho = f + kappa * min(room // (kappa * 4 * hc), (hidden - 1) // kappa)
    smem = 4 * _grid_floats(f, hidden, blocks, tile, backward, mode, kappa, rho)
    return (smem, rho) if smem <= MAX_SHARED_BYTES else None


def grid_plans(batch: int, f: int, hidden: int, backward: bool, sms: int = SMS):
    """Yields every :class:`Plan` of the grid layout that fits at (B, F, H)
    on a card of ``sms`` SMs: first, over :func:`_grid_shapes`, each whose
    block holds the whole (mode 0) within ``MAX_SHARED_BYTES``; then, over
    the same shapes whose block does not, for each chunk width of
    ``KAPPAS``, the least streaming of ``STREAM_LEVELS`` that fits (under
    ``STREAM_COLS`` with the most rows held)."""
    shapes = list(_grid_shapes(batch, hidden, sms))
    whole = set()
    for rows, blocks, hc, groups, tiles in shapes:
        smem = 4 * _grid_floats(f, hidden, blocks, groups * rows, backward)
        if smem <= MAX_SHARED_BYTES:
            whole.add((rows, blocks, groups))
            yield Plan("grid", groups, smem, hc, 0, 0, 0, blocks,
                       sms // (blocks * tiles), sms, rows)
    for rows, blocks, hc, groups, tiles in shapes:
        if (rows, blocks, groups) in whole:
            continue
        for kappa in KAPPAS:
            for mode in STREAM_LEVELS[backward]:
                fit = _streamed(f, hidden, blocks, groups * rows, backward, mode, kappa)
                if fit is not None:
                    yield Plan("grid", groups, fit[0], hc, mode, 0, 0, blocks,
                               sms // (blocks * tiles), sms, rows, kappa, fit[1])
                    break


def stream_plan(p: Plan, f: int, hidden: int, backward: bool, mode: int, kappa: int = KAPPA,
                rho: Optional[int] = None) -> Plan:
    """The grid plan ``p`` with the streaming ``mode`` (a level of
    ``STREAM_LEVELS``), chunks of ``kappa`` columns and, under
    ``STREAM_COLS``, rows [0, ``rho``) of the columns held (default: the
    most that fit): for the launchers' ``_plan``, e.g. to hold a streamed
    launch against the whole one at a shape that needs none.  Raises where
    the block does not fit."""
    if p.layout != "grid" or mode not in STREAM_LEVELS[backward]:
        raise ValueError(f"stream_plan takes a grid plan and one of {STREAM_LEVELS[backward]}")
    if kappa < 4 or kappa % 4 or (rho is not None and not (
            f <= rho < f + hidden and (rho - f) % kappa == 0)):
        raise ValueError(f"kappa={kappa}, rho={rho}: kappa a multiple of 4, rho F plus a "
                         "multiple of it, below F + H")
    fit = _streamed(f, hidden, p.blocks, p.groups * p.rows, backward, mode, kappa, rho)
    if fit is None:
        raise ValueError(f"F={f}, H={hidden}: a grid block of mode {mode}, kappa={kappa} does "
                         "not fit its shared memory")
    return p._replace(smem=fit[0], mode=mode, kappa=kappa, rho=fit[1])


def _grid_plan(batch: int, f: int, hidden: int, backward: bool, sms: int) -> Optional[Plan]:
    """Of :func:`grid_plans`, those that stream nothing if any, else those
    of the least streaming (the fewest bits of ``mode``); of them those
    with the fewest batch tiles; of them those whose threads own the fewest
    rows; when streamed, of them those with the widest chunks, under
    ``STREAM_COLS`` then those with the most rows held; then the fewest
    blocks of at most ``GRID_THREADS`` threads (else the fewest blocks).  On an H100 at one lane of (B, F, H) = (32, 6, 512)
    that is 1 row a thread, K = 128 blocks of 128 threads: forward 0.36730
    ms, backward 1.19990, the fastest of every plan with a 32-row tile but
    the backward's K = 86 (1.20793); 4 rows a thread took 0.53502 and
    1.92836 at its best K (``kernel_bench.py --lstm-plans``)."""
    whole, plans = [], []
    for p in grid_plans(batch, f, hidden, backward, sms):
        if not p.mode:
            whole.append(p)
        elif whole:
            break           # the streamed plans come after every whole one
        else:
            plans.append(p)
    if whole:
        plans = whole
    elif not plans:
        return None
    else:
        level = min(bin(p.mode).count("1") for p in plans)
        plans = [p for p in plans if bin(p.mode).count("1") == level]
    tiles = min(-(-batch // (p.groups * p.rows)) for p in plans)
    plans = [p for p in plans if -(-batch // (p.groups * p.rows)) == tiles]
    rows = min(p.rows for p in plans)
    plans = [p for p in plans if p.rows == rows]
    if plans[0].mode:
        kappa = max(p.kappa for p in plans)
        plans = [p for p in plans if p.kappa == kappa]
    if plans[0].mode & STREAM_COLS:
        rho = max(p.rho for p in plans)
        plans = [p for p in plans if p.rho == rho]
    narrow = [p for p in plans if p.span * p.groups <= GRID_THREADS]
    return min(narrow or plans, key=lambda p: p.blocks)


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device) -> int:
    """The streaming multiprocessors of ``device`` if it is a GPU, else
    ``SMS`` (an H100 SXM's): the count a plan made off the card assumes."""
    device = torch.device(device)
    if device.type != "cuda":
        return SMS
    return _cuda_sms(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=4096)
def plan(batch: int, f: int, hidden: int, backward: bool = False, *, lanes: int = 1,
         sms: int = SMS, _layout: Optional[str] = None, _cluster: Optional[int] = None) -> Plan:
    """The :class:`Plan` of one launch of ``lanes`` lanes at (B, F, H).
    The shared-memory layout where a block of ``_groups`` groups, or fewer,
    fits ``MAX_SHARED_BYTES`` (up to H = 114 at F = 6, 115 in the forward);
    else a cluster's (up to H = 334 at F = 6, 461 in the forward); else the
    grid's across the card, whole in each block up to H = 660 at F = 6,
    B = 32 (924 in the forward) and past that with the least streaming that
    fits (:func:`grid_plans`), up to H = 4,224 at F = 6, B = 32 in both
    directions (past H = 1,056 at B = 128: K x tiles blocks of at most 256
    threads no longer fit the card's SMs); else the weights through L2, for
    any F >= 1 and H >= 1.
    ``sms`` is the card's count of SMs (:func:`device_sms`), which sizes
    the cluster and bounds the grid.  ``_layout`` forces one (the checks
    that the layouts give the same bits, through the launchers' ``_plan``)
    and raises where it does not fit; ``_cluster`` forces the cluster's
    size.  Cached: a launch's plan costs the host one lookup."""
    if f < 1 or hidden < 1:
        raise ValueError(f"the LSTM kernels take F >= 1 and H >= 1 (got F={f}, H={hidden})")
    if _layout not in (None,) + LAYOUTS:
        raise ValueError(f"unknown layout {_layout!r} (one of {LAYOUTS})")
    if _cluster is not None and (_cluster not in CLUSTERS or _layout not in (None, "cluster")):
        raise ValueError(f"a cluster of {_cluster} blocks: one of {CLUSTERS}, in that layout")
    if _layout in (None, "smem") and _cluster is None and hidden <= MAX_THREADS:
        for groups in range(_groups(batch, hidden), 0, -1):
            smem = _shared_bytes(f, hidden, groups * ROWS, backward)
            if smem <= MAX_SHARED_BYTES:
                return Plan("smem", groups, smem, hidden)
    if _layout == "smem":
        raise ValueError(f"F={f}, H={hidden}: a lane's weights do not fit a block's shared memory")
    if _layout in (None, "cluster"):
        p = _cluster_plan(batch, f, hidden, backward, lanes, sms, _cluster)
        if p is not None:
            return p
        if _layout == "cluster" or _cluster is not None:
            raise ValueError(f"F={f}, H={hidden}: a lane's weights do not fit the shared "
                             "memory of a cluster" + (f" of {_cluster}" if _cluster else ""))
    if _layout in (None, "grid"):
        p = _grid_plan(batch, f, hidden, backward, sms)
        if p is not None:
            return p
        if _layout == "grid":
            raise ValueError(f"F={f}, H={hidden}, B={batch}: a lane's weights do not fit the "
                             f"shared memory of {sms} blocks across the card (the grid layout)")
    span = -(-hidden // -(-hidden // L2_THREADS))    # the fewest passes of <= 256 columns
    groups = _groups(batch, span)
    tile = groups * ROWS
    stage = _l2_stage_floats(span) if backward else 0
    for mode in ((0, DGATES_OUT) if backward else (0,)):
        smem = 4 * (_state_floats(hidden, tile, backward, mode) + stage)
        if smem <= MAX_SHARED_BYTES:
            return Plan("l2", groups, smem, span, mode)
    mode = STATE_GLOBAL | (DGATES_OUT if backward else 0)
    return Plan("l2", groups, 4 * stage, span, mode, _state_floats(hidden, tile, backward, mode))


def _work(x_seq, p: Plan, lanes: int, batch: int, hidden: int, backward: bool):
    """The scratch buffers of a launch, (work, sync), each None where the
    launch takes none.  work: the state of an L2 launch whose state lies in
    global memory (``state`` floats for each block of the first
    ``MAX_GRID_Y`` lanes), or a grid forward's exchange of h (two (tile,
    H + 4 rounded) halves for each tile of ``per_launch`` lanes, which each
    launch reuses), followed under ``STREAM_COLS`` (in the backward alone)
    by the packed copy of the streamed rows of the columns, (F + H - rho) x
    Hc float4s for each block of ``per_launch`` lanes.  sync: a grid
    launch's arrival counters, zeroed, one a tile of every lane."""
    tiles = -(-batch // (p.groups * p.rows))
    if p.layout == "grid":
        sync = torch.zeros(lanes * tiles, dtype=torch.int32, device=x_seq.device)
        blocks = min(lanes, p.per_launch) * tiles
        exchange = 0 if backward else blocks * 2 * p.groups * p.rows * (_round4(hidden) + 4)
        packed = 0
        if p.mode & STREAM_COLS:
            packed = blocks * p.blocks * (x_seq.shape[-1] + hidden - p.rho) * 4 * p.span
        if exchange + packed == 0:
            return None, sync
        return x_seq.new_empty(exchange + packed), sync
    if not p.state:
        return None, None
    return x_seq.new_empty(tiles * min(lanes, MAX_GRID_Y) * p.state), None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _lane_arg(name: str, t: torch.Tensor, shape, index: int) -> int:
    """Check one input (fp32, the given shape, each lane's block
    contiguous, on the device whose ``Tensor.get_device()`` is ``index``:
    x_seq's, -1 off the GPU, which :func:`_require_cuda` refuses after the
    layouts) and return its lane stride in elements."""
    if t.dtype is not torch.float32:
        raise ValueError(f"{name} must be torch.float32 (got {t.dtype})")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)} (got {tuple(t.shape)})")
    strides = t.stride()
    dense = 1
    for dim in range(len(shape) - 1, 0, -1):
        if shape[dim] > 1 and strides[dim] != dense:
            raise ValueError(f"{name} must be contiguous within a lane")
        dense *= shape[dim]
    if t.get_device() != index:
        raise ValueError(f"{name} must be a CUDA tensor on x_seq's device (got {t.device})")
    stride = strides[0] if shape[0] > 1 else 0
    if not 0 <= stride <= _INT_MAX or t.numel() > _INT_MAX:
        raise ValueError(f"{name} is too large for 32-bit offsets")
    return stride


def _seq_shapes(x_seq, h, backward, forced):
    """(lanes, steps, batch, f, hidden, plan, device index) of a launch:
    the plan made, the device not yet checked (the index is
    ``x_seq.get_device()``, -1 off the GPU; see :func:`_require_cuda`)."""
    if x_seq.dim() != 4 or h.dim() != 3:
        raise ValueError("x_seq must be (L, T, B, F) and the states (L, B, H)")
    lanes, steps, batch, f = x_seq.shape
    hidden = h.shape[2]
    p = forced or plan(batch, f, hidden, backward, lanes=lanes, sms=device_sms(x_seq.device))
    if steps < 1:
        raise ValueError("the sequence needs at least one step")
    return lanes, steps, batch, f, hidden, p, x_seq.get_device()


def _require_cuda(x_seq) -> None:
    """After every argument's layout is checked against x_seq's device:
    that device must be a GPU."""
    if not x_seq.is_cuda:
        raise ValueError(f"x_seq must be a CUDA tensor (got {x_seq.device})")


def _weight_strides(wx, wh, b, lanes, f, hidden, dev):
    return [_lane_arg("wx", wx, (lanes, f, 4 * hidden), dev),
            _lane_arg("wh", wh, (lanes, hidden, 4 * hidden), dev),
            _lane_arg("b", b, (lanes, 4 * hidden), dev)]


def lstm_seq_cuda(x_seq, h0, c0, wx, wh, b, save: bool = False, *,
                  _plan: Optional[Plan] = None):
    """x_seq (L, T, B, F), h0 and c0 (L, B, H), wx (L, F, 4H), wh (L, H, 4H),
    b (L, 4H), fp32 on one CUDA device, each lane's block contiguous (the
    lane stride is free) -> (h, c): the final states, each a contiguous
    (L, B, H), or with ``save`` the states before and after every step,
    each a contiguous (L, T+1, B, H) whose [:, 0] is h0, c0.  ``_plan``
    replaces the launch's :func:`plan`, e.g. one made with ``_layout`` to
    force a layout (the source refuses one that does not match its own
    layouts)."""
    global launches, cluster_launches, grid_launches, l2_launches
    lanes, steps, batch, f, hidden, p, dev = _seq_shapes(x_seq, h0, False, _plan)
    x_ls = _lane_arg("x_seq", x_seq, (lanes, steps, batch, f), dev)
    h_ls = _lane_arg("h0", h0, (lanes, batch, hidden), dev)
    c_ls = _lane_arg("c0", c0, (lanes, batch, hidden), dev)
    w_ls = _weight_strides(wx, wh, b, lanes, f, hidden, dev)
    _require_cuda(x_seq)
    shape = (lanes, steps + 1, batch, hidden) if save else (lanes, batch, hidden)
    h_out = x_seq.new_empty(shape)
    c_out = x_seq.new_empty(shape)
    if lanes * batch * hidden == 0:
        return h_out, c_out
    work, sync = _work(x_seq, p, lanes, batch, hidden, False)
    _fwd(x_seq.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
         b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), _ptr(work), _ptr(sync), lanes, steps,
         batch, f, hidden, p.groups, int(save), x_ls, h_ls, c_ls, *w_ls,
         _LAYOUT_CODES[p.layout], p.span, p.cluster, p.blocks, p.per_launch, p.rows, p.mode,
         p.kappa, p.rho, p.smem, current_stream(dev))
    launches += 1
    cluster_launches += p.layout == "cluster"
    grid_launches += p.layout == "grid"
    l2_launches += p.layout == "l2"
    return h_out, c_out


def lstm_seq_backward_cuda(x_seq, h_seq, c_seq, wx, wh, b, dh_last, dc_last, *,
                           _plan: Optional[Plan] = None):
    """The backward of :func:`lstm_seq_cuda` from its saved states: x_seq,
    wx, wh, b as there; h_seq, c_seq (L, T+1, B, H) and the cotangents of
    the final states dh_last, dc_last (L, B, H), contiguous.  Returns
    (dgates (L, T, B, 4H), dh0, dc0 (L, B, H)), contiguous: the cotangents
    of each step's gate pre-activations and of the initial states.
    ``_plan`` as for :func:`lstm_seq_cuda`."""
    global bwd_launches, cluster_bwd_launches, grid_bwd_launches, l2_bwd_launches
    lanes, steps, batch, f, hidden, p, dev = _seq_shapes(x_seq, dh_last, True, _plan)
    x_ls = _lane_arg("x_seq", x_seq, (lanes, steps, batch, f), dev)
    w_ls = _weight_strides(wx, wh, b, lanes, f, hidden, dev)
    seq, last = (lanes, steps + 1, batch, hidden), (lanes, batch, hidden)
    if check_args(("h_seq", h_seq, torch.float32, seq), ("c_seq", c_seq, torch.float32, seq),
                  ("dh_last", dh_last, torch.float32, last),
                  ("dc_last", dc_last, torch.float32, last)) != dev:
        raise ValueError(f"h_seq must be a CUDA tensor on x_seq's device (got {h_seq.device})")
    _require_cuda(x_seq)
    dgates = x_seq.new_empty((lanes, steps, batch, 4 * hidden))
    dh0 = x_seq.new_empty(last)
    dc0 = x_seq.new_empty(last)
    if lanes * batch * hidden == 0:
        return dgates, dh0, dc0
    work, sync = _work(x_seq, p, lanes, batch, hidden, True)
    _bwd(x_seq.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(), wx.data_ptr(),
         wh.data_ptr(), b.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(),
         dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), _ptr(work), _ptr(sync), lanes,
         steps, batch, f, hidden, p.groups, x_ls, *w_ls, _LAYOUT_CODES[p.layout], p.span,
         p.cluster, p.blocks, p.per_launch, p.rows, p.mode, p.kappa, p.rho, p.smem,
         current_stream(dev))
    bwd_launches += 1
    cluster_bwd_launches += p.layout == "cluster"
    grid_bwd_launches += p.layout == "grid"
    l2_bwd_launches += p.layout == "l2"
    return dgates, dh0, dc0


def lstm_cell_cuda(x, h, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """One timestep: x (L, B, F), h and c (L, B, H), wx (L, F, 4H),
    wh (L, H, 4H), b (L, 4H) -> (h', c'), each a contiguous (L, B, H); the
    forward kernel at T = 1.  Without the lane axis (x (B, F), b (4H,)) it
    is one lane."""
    if x.dim() == 2:
        h_out, c_out = lstm_cell_cuda(x[None], h[None], c[None], wx[None],
                                      wh[None], b[None])
        return h_out[0], c_out[0]
    if x.dim() != 3:
        raise ValueError("x must be (L, B, F)")
    return lstm_seq_cuda(x[:, None], h, c, wx, wh, b)
