"""The port's shared launch path (``kernels/common.py``, ``kernels/_build.py``)
and what every launcher checks before it passes a pointer on; on a card,
the redesigned squared-norm and AES-128-CTR kernels at edge shapes, the
1-D quantize path's outputs, every launcher on a non-default stream, the
batched dequantize of the fleet's refresh rows, and the mobility world's
draws and arithmetic on the card against the CPU.

The CPU cases run anywhere; the ``cuda``-marked ones skip without a card
and run on it with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_launch.py``.
"""

import ctypes
import re

import numpy as np
import pytest

import torch

from repro_torch.core import crypto
from repro_torch.kernels import _build, common
from repro_torch.kernels.aes_ctr import kernel as ak
from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
from repro_torch.kernels.fedavg import kernel as fk
from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
from repro_torch.kernels.lstm_cell import kernel as lk
from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref
from repro_torch.kernels.quantize import kernel as qk
from repro_torch.kernels.quantize.ref import (dequantize_batched_ref, dequantize_ref,
                                              quantize_batched_ref)
from repro_torch.kernels.robust import kernel as rk
from repro_torch.kernels.robust import ref as rr

LAUNCHER_MODULES = (ak, fk, lk, qk, rk)
F32, I8, U8 = torch.float32, torch.int8, torch.uint8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _c_functions():
    """Every C launcher the launcher modules hold."""
    out = []
    for mod in LAUNCHER_MODULES:
        for value in vars(mod).values():
            found = value.values() if isinstance(value, dict) else (value,)
            out += [f for f in found if isinstance(f, _build.CFunction)]
    return out


# ---------------------------------------------------------------------------
# the shared launch path, on the CPU
# ---------------------------------------------------------------------------


def test_every_launcher_holds_a_c_function_of_the_sources():
    names = sorted(f.name for f in _c_functions())
    exported = sorted(m for src in _build.sources()
                      for m in re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert names == exported


@pytest.mark.parametrize("fn", _c_functions(), ids=[f.name for f in _c_functions()])
def test_c_function_argtypes_follow_the_c_signature(fn):
    """A pointer for every ``void*``, an int for every ``int``, in order;
    the stream last."""
    src = "\n".join(p.read_text() for p in _build.sources())
    params = re.search(rf'extern "C" int {fn.name}\(([^)]*)\)', src).group(1).split(",")
    assert all("void*" in p or p.split()[0] == "int" for p in params)
    assert fn.argtypes == [ctypes.c_void_p if "void*" in p else ctypes.c_int for p in params]
    assert fn.argtypes[-1] is ctypes.c_void_p and "stream" in params[-1]


def test_c_function_resolves_once_and_raises_on_a_cuda_error(monkeypatch):
    calls, results = [], iter([0, 700])

    def resolve(name, argtypes):
        calls.append(name)
        return lambda *args: next(results)

    monkeypatch.setattr(_build, "function", resolve)
    fn = _build.CFunction("probe_launch", [ctypes.c_void_p])
    fn(0)
    with pytest.raises(RuntimeError, match="probe_launch failed with CUDA error 700"):
        fn(0)
    assert calls == ["probe_launch"]


def test_check_args_refuses_layout_before_device():
    a, b = torch.zeros(2, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="a must be a CUDA tensor"):
        common.check_args(("a", a, F32, (2, 3)), ("b", b, F32, None))
    with pytest.raises(ValueError, match=r"b must be torch\.float32"):
        common.check_args(("a", a, F32, None), ("b", b.double(), F32, None))
    with pytest.raises(ValueError, match=r"b must have shape \(3, 2\)"):
        common.check_args(("a", a, F32, None), ("b", b, F32, (3, 2)))
    with pytest.raises(ValueError, match="b must be contiguous"):
        common.check_args(("a", a, F32, None), ("b", b.t(), F32, None))


def test_current_stream_reads_the_raw_handle_where_torch_has_it():
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    assert common.current_stream is (raw or common._stream_handle)


def test_is_cpu_dispatches_on_the_tensor():
    assert common.is_cpu(torch.zeros(1))
    with pytest.raises(ValueError, match="unsupported device"):
        common.is_cpu(torch.zeros(1, device="meta"))


# ---------------------------------------------------------------------------
# what each launcher refuses, on the CPU
# ---------------------------------------------------------------------------


def _noncontiguous(t):
    """The same values and shape, not contiguous."""
    if t.dim() == 1:
        out = torch.zeros(2 * t.shape[0], dtype=t.dtype)[::2]
        out.copy_(t)
        return out
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


def _robust_args(q8):
    if q8:
        return [torch.zeros(2, 3, 1024, dtype=I8), torch.ones(2, 3, 1), torch.ones(2, 3)]
    return [torch.zeros(2, 3, 8), torch.ones(2, 3)]


def _lstm_args(backward):
    lanes, t, b, f, h = 2, 3, 4, 5, 6
    x = torch.zeros(lanes, t, b, f)
    w = [torch.zeros(lanes, f, 4 * h), torch.zeros(lanes, h, 4 * h), torch.zeros(lanes, 4 * h)]
    state = torch.zeros(lanes, b, h)
    if backward:
        seq = torch.zeros(lanes, t + 1, b, h)
        return [x, seq, seq.clone(), *w, state, state.clone()]
    return [x, state, state.clone(), *w]


# launcher, its valid CPU arguments, and for each fault: (argument index,
# the faulty argument, the reason the refusal names)
LAUNCHERS = {
    "fedavg": (fk.fedavg_batched_cuda, lambda: [torch.zeros(2, 3, 8), torch.ones(2, 3)],
               {"dtype": (0, lambda t: t.double()), "shape": (1, lambda t: torch.ones(2, 4)),
                "contiguous": (0, _noncontiguous)}),
    "fedavg_q8": (fk.fedavg_batched_q8_cuda, lambda: _robust_args(True),
                  {"dtype": (0, lambda t: t.to(U8)), "shape": (1, lambda t: torch.ones(2, 3, 2)),
                   "contiguous": (2, _noncontiguous)}),
    "quantize": (qk.quantize_cuda, lambda: [torch.zeros(2, 100)],
                 {"dtype": (0, lambda t: t.double()), "shape": (0, lambda t: t[None]),
                  "contiguous": (0, _noncontiguous)}),
    "dequantize": (qk.dequantize_cuda,
                   lambda: [torch.zeros(1024, dtype=I8), torch.ones(1), 10],
                   {"dtype": (0, lambda t: t.to(U8)), "shape": (1, lambda t: torch.ones(2)),
                    "contiguous": (0, _noncontiguous)}),
    "aes_ctr": (ak.aes_ctr_cuda,
                lambda: [torch.zeros(40, dtype=U8), torch.zeros(11, 16, dtype=U8),
                         torch.zeros(8, dtype=U8), torch.from_numpy(crypto.TABLES)],
                {"dtype": (0, lambda t: t.to(I8)),
                 "shape": (1, lambda t: torch.zeros(10, 16, dtype=U8)),
                 "contiguous": (0, _noncontiguous)}),
    "trimmed_mean": (rk.trimmed_mean_cuda, lambda: _robust_args(False),
                     {"dtype": (1, lambda t: t.double()), "shape": (1, lambda t: torch.ones(2, 4)),
                      "contiguous": (0, _noncontiguous)}),
    "median": (rk.median_cuda, lambda: _robust_args(False),
               {"dtype": (0, lambda t: t.half()), "shape": (1, lambda t: torch.ones(3, 3)),
                "contiguous": (1, _noncontiguous)}),
    "trimmed_mean_q8": (rk.trimmed_mean_q8_cuda, lambda: _robust_args(True),
                        {"dtype": (1, lambda t: t.double()),
                         "shape": (1, lambda t: torch.ones(2, 3, 2)),
                         "contiguous": (0, _noncontiguous)}),
    "median_q8": (rk.median_q8_cuda, lambda: _robust_args(True),
                  {"dtype": (2, lambda t: t.double()), "shape": (2, lambda t: torch.ones(2, 2)),
                   "contiguous": (0, _noncontiguous)}),
    "sqnorm": (rk.sqnorm_cuda, lambda: [torch.zeros(2, 3, 8)],
               {"dtype": (0, lambda t: t.double()), "shape": (0, lambda t: t[0]),
                "contiguous": (0, _noncontiguous)}),
    "sqnorm_q8": (rk.sqnorm_q8_cuda, lambda: _robust_args(True)[:2],
                  {"dtype": (0, lambda t: t.to(U8)), "shape": (1, lambda t: torch.ones(2, 3, 2)),
                   "contiguous": (0, _noncontiguous)}),
    "lstm_seq": (lk.lstm_seq_cuda, lambda: _lstm_args(False),
                 {"dtype": (1, lambda t: t.double()), "shape": (5, lambda t: torch.zeros(2, 25)),
                  "contiguous": (4, _noncontiguous)}),
    "lstm_seq_bwd": (lk.lstm_seq_backward_cuda, lambda: _lstm_args(True),
                     {"dtype": (7, lambda t: t.double()),
                      "shape": (2, lambda t: torch.zeros(2, 3, 4, 6)),
                      "contiguous": (1, _noncontiguous)}),
}
REASONS = {"cpu": "CUDA", "dtype": r"must be torch\.", "shape": r"shape|must be \(",
           "contiguous": "contiguous"}


@pytest.mark.parametrize("fault", list(REASONS))
@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_refuses_before_launching(name, fault):
    """A CPU tensor, a wrong dtype, a wrong shape and a non-contiguous
    input each raise, naming their reason, and nothing is launched."""
    from repro_torch import kernels

    launcher, make, faults = LAUNCHERS[name]
    args = make()
    if fault != "cpu":
        i, bad = faults[fault]
        args[i] = bad(args[i])
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=REASONS[fault]):
        launcher(*args)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("off", [1, 2, 3])
def test_fedavg_q8_refuses_codes_off_a_word(off):
    """The int8 eq. 14 kernel reads 4 codes a load, so codes that start
    1-3 bytes past a 4-byte boundary raise, naming it, and nothing is
    launched."""
    from repro_torch import kernels

    q, s, w = _robust_args(True)
    codes = torch.zeros(q.numel() + 3, dtype=I8)[off:off + q.numel()].view(q.shape)
    assert codes.data_ptr() % 4
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="4-byte boundary"):
        fk.fedavg_batched_q8_cuda(codes, s, w)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card: the squared norm
# ---------------------------------------------------------------------------

# L mod 4 = 0, 1, 2, 3, L < 256, one and two 4,096-element chunks and their
# edges, and the fleet's L = 18,566 with R * N odd
SQNORM_SHAPES = [(2, 3, 1), (1, 5, 3), (3, 1, 7), (2, 2, 100), (1, 3, 255), (2, 3, 4096),
                 (2, 3, 4097), (1, 3, 4098), (3, 3, 4099), (1, 2, 16384 + 6), (3, 5, 18566),
                 (1, 1, 65539)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,l", SQNORM_SHAPES)
def test_sqnorm_kernels_at_edge_lengths(r, n, l, cuda_device):
    g = torch.Generator().manual_seed(r * 100_003 + n * 1009 + l)
    x = torch.randn((r, n, l), generator=g)
    x[0, 0, : min(l, 64)] *= 1e3                                   # a noise-sized outlier
    q, s = quantize_batched_ref(x.reshape(r * n, l))
    lp = q.shape[-1]
    q, s = q.reshape(r, n, lp).to(cuda_device), s.reshape(r, n, -1).to(cuda_device)
    dq = dequantize_batched_ref(q, s).contiguous()
    xd = x.to(cuda_device)
    sq = rk.sqnorm_cuda(xd)
    torch.cuda.synchronize()
    torch.testing.assert_close(sq, rr.sqnorm_batched_ref(xd), rtol=1e-5, atol=1e-6)
    # deterministic: no atomics, a fixed order
    assert torch.equal(rk.sqnorm_cuda(xd), sq)
    # the q8 kernel equals the dense one on the dequantized buffer, over the
    # padded Lp and over P alone, bit for bit
    sq8 = rk.sqnorm_q8_cuda(q, s)
    assert torch.equal(sq8, rk.sqnorm_cuda(dq))
    assert torch.equal(sq8, rk.sqnorm_cuda(dq[..., :l].contiguous()))
    assert torch.equal(rk.sqnorm_q8_cuda(q, s), sq8)


@pytest.mark.cuda
def test_sqnorm_takes_rows_at_every_alignment(cuda_device):
    """A buffer that starts 4, 8 and 12 bytes past a 16-byte boundary (the
    kernel's scalar, float2 and float4 paths) gives the same bits."""
    g = torch.Generator().manual_seed(5)
    base = torch.randn((3 * 5 * 18566 + 4,), generator=g).to(cuda_device)
    want = rk.sqnorm_cuda(base[:3 * 5 * 18566].reshape(3, 5, 18566).clone())
    for off in (1, 2, 3):
        x = base[off:off + 3 * 5 * 18566].reshape(3, 5, 18566)
        ref = rk.sqnorm_cuda(x.clone())
        got = rk.sqnorm_cuda(x)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        torch.testing.assert_close(got, rr.sqnorm_batched_ref(x), rtol=1e-5, atol=1e-6)
    assert want.shape == (3, 5)


# ---------------------------------------------------------------------------
# on the card: quantize of one row
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 1000 + 7, 18566])
def test_quantize_of_one_row_returns_1d_tensors_of_their_own(l, cuda_device):
    """A 1-D update gets (Lp,) codes and (Lp / 1024,) scales allocated as
    such, contiguous and no views of a (1, Lp) tensor, bit-equal to the
    twin's."""
    g = torch.Generator().manual_seed(l)
    v = (torch.randn((l,), generator=g) * 0.3).to(cuda_device)
    q, s = qk.quantize_cuda(v)
    torch.cuda.synchronize()
    lp = l + (-l) % 1024
    assert (q.shape, s.shape) == ((lp,), (lp // 1024,))
    assert q.is_contiguous() and s.is_contiguous()
    assert q._base is None and s._base is None
    qr, sr = quantize_batched_ref(v)
    assert torch.equal(q, qr) and torch.equal(s, sr)


# ---------------------------------------------------------------------------
# on the card: AES-128-CTR
# ---------------------------------------------------------------------------

AES_CARD_SIZES = [1, 15, 16, 17, 4080, 65539, 74264, 19532]


def _aes_material(seed, dev):
    rng = np.random.default_rng(seed)
    rk_ = torch.from_numpy(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8)))
    nonce = torch.from_numpy(rng.integers(0, 256, 8).astype(np.uint8))
    return rng, rk_.to(dev), nonce.to(dev), torch.from_numpy(crypto.TABLES).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", AES_CARD_SIZES)
def test_aes_kernel_is_byte_exact_at_every_size(n, cuda_device):
    rng, rk_, nonce, tables = _aes_material(n, cuda_device)
    pay = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)).to(cuda_device)
    got = ak.aes_ctr_cuda(pay, rk_, nonce, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ctr_ref(pay, rk_, nonce, tables))
    assert torch.equal(ak.aes_ctr_cuda(got, rk_, nonce, tables), pay)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_aes_kernel_takes_unaligned_payloads(offset, cuda_device):
    rng, rk_, nonce, tables = _aes_material(100 + offset, cuda_device)
    buf = torch.from_numpy(rng.integers(0, 256, 4096 + 37).astype(np.uint8)).to(cuda_device)
    pay = buf[offset:offset + 4096 + 5]
    got = ak.aes_ctr_cuda(pay, rk_, nonce, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, aes_ctr_ref(pay, rk_, nonce, tables))


@pytest.mark.cuda
def test_aes_keystream_is_the_fips197_checked_block_cipher(cuda_device):
    """A zero payload's keystream block k is AES-128 of nonce || k as
    ``crypto.aes128_encrypt_blocks`` computes it, the block cipher that
    ``test_fips197_block_through_the_port`` holds to the FIPS-197 vector."""
    rng, rk_, nonce, tables = _aes_material(197, cuda_device)
    blocks = 300
    out = ak.aes_ctr_cuda(torch.zeros(16 * blocks, dtype=U8, device=cuda_device), rk_, nonce,
                          tables)
    torch.cuda.synchronize()
    counters = torch.cat([nonce.cpu()[None].expand(blocks, 8),
                          torch.tensor([list(k.to_bytes(8, "big")) for k in range(blocks)],
                                       dtype=U8)], dim=1)
    want = crypto.aes128_encrypt_blocks(counters, rk_.cpu().numpy())
    assert torch.equal(out.cpu().reshape(blocks, 16), want)


# ---------------------------------------------------------------------------
# on the card: every launcher runs on the caller's current stream
# ---------------------------------------------------------------------------


def _stream_cases(dev):
    """name -> (launcher, its inputs, the plain twin); the first input is
    the one the test writes on the side stream."""
    g = torch.Generator().manual_seed(3)
    u, w = torch.randn((2, 3, 2048 + 5), generator=g), torch.rand((2, 3), generator=g) + 0.1
    q, s = quantize_batched_ref(u.reshape(6, -1))
    q, s = q.reshape(2, 3, -1), s.reshape(2, 3, -1)
    lanes, t, b, f, h = 2, 3, 4, 5, 6
    x = torch.randn((lanes, t, b, f), generator=g)
    st = [torch.randn((lanes, b, h), generator=g) * 0.5 for _ in range(4)]
    wts = [torch.randn((lanes, f, 4 * h), generator=g) * 0.4,
           torch.randn((lanes, h, 4 * h), generator=g) * 0.4,
           torch.randn((lanes, 4 * h), generator=g) * 0.1]
    hs, cs = lstm_seq_ref(x, st[0], st[1], *wts)
    _, rk_, nonce, tables = _aes_material(9, "cpu")
    pay = torch.from_numpy(np.random.default_rng(9).integers(0, 256, 1003).astype(np.uint8))
    cases = {
        "fedavg": (fk.fedavg_batched_cuda, [u, w], fedavg_batched_ref),
        "fedavg_q8": (fk.fedavg_batched_q8_cuda, [q, s, w], fedavg_batched_q8_ref),
        "quantize": (qk.quantize_cuda, [u[0]], quantize_batched_ref),
        "dequantize": (lambda a, b_: qk.dequantize_cuda(a, b_, 2000), [q[0, 0], s[0, 0]],
                       lambda a, b_: dequantize_ref(a, b_, 2000)),
        "aes_ctr": (ak.aes_ctr_cuda, [pay, rk_, nonce, tables], aes_ctr_ref),
        "trimmed_mean": (rk.trimmed_mean_cuda, [u, w], rr.trimmed_mean_batched_ref),
        "median": (rk.median_cuda, [u, w], rr.median_batched_ref),
        "trimmed_mean_q8": (rk.trimmed_mean_q8_cuda, [q, s, w], rr.trimmed_mean_batched_q8_ref),
        "median_q8": (rk.median_q8_cuda, [q, s, w], rr.median_batched_q8_ref),
        "sqnorm": (rk.sqnorm_cuda, [u], rr.sqnorm_batched_ref),
        "sqnorm_q8": (rk.sqnorm_q8_cuda, [q, s], rr.sqnorm_batched_q8_ref),
        "lstm_seq": (lambda *a: lk.lstm_seq_cuda(*a, save=True), [x, st[0], st[1], *wts],
                     lstm_seq_ref),
        "lstm_seq_bwd": (lk.lstm_seq_backward_cuda, [x, hs, cs, *wts, st[2], st[3]],
                         lambda *a: lstm_seq_backward_ref(*a)[:3]),
    }
    return {k: (fn, [a.to(dev) for a in args], twin) for k, (fn, args, twin) in cases.items()}


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_runs_on_the_current_stream(name, cuda_device):
    """The first input is written on a side stream behind a long sleep, and
    the launcher is called inside ``torch.cuda.stream`` of that stream: it
    sees the written input only if it launched there (on the default
    stream it would run at once, on the stale zeros)."""
    launcher, args, twin = _stream_cases(cuda_device)[name]
    src = args[0]
    dst = torch.zeros_like(src)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)                  # ~50 ms of the side stream
        dst.copy_(src)
        out = launcher(dst, *args[1:])
    torch.cuda.synchronize()
    want = twin(src, *args[1:])
    for got, ref in zip(_flat(out), _flat(want)):
        if got.dtype.is_floating_point:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_batched_dequantize_launches_the_kernel_once(cuda_device):
    """The fleet's refresh source, (rows, Lp) codes and scales: one launch
    over the rows as one buffer, the twin's bits."""
    from repro_torch.kernels.quantize.ops import dequantize_flat_batched

    g = torch.Generator().manual_seed(3)
    q, s = quantize_batched_ref(torch.randn((320, 18566), generator=g))
    q, s = q.to(cuda_device), s.to(cuda_device)
    before = qk.dequantize_launches
    got = dequantize_flat_batched(q, s)
    torch.cuda.synchronize()
    assert qk.dequantize_launches == before + 1
    assert got.shape == q.shape and torch.equal(got, dequantize_batched_ref(q, s))
    three = dequantize_flat_batched(q.view(64, 5, -1), s.view(64, 5, -1))
    assert three.shape == (64, 5, q.shape[1]) and torch.equal(three.view(320, -1), got)


@pytest.mark.cuda
def test_mobility_world_on_the_card_equals_the_world_on_the_cpu(cuda_device):
    """The fleet renegotiates on its device, the loop engine on the host:
    the draws, the integer distances and the fp32 utilities and batteries
    must be the same bits on both, under both threefry modes."""
    from repro_torch.core import mobility as tmob

    mob = tmob.MobilityConfig(arena_m=200.0, radio_range_m=90.0, leg_rounds=2, seed=5)
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.choice(np.float32([0.1, 0.3, 0.5]), (64, 5)).astype(np.float32))
    level = torch.from_numpy(rng.choice(np.float32([0.05, 0.1, 0.5, 0.9]),
                                        (64, 5)).astype(np.float32))
    mask = torch.from_numpy(rng.random((64, 5)) < 0.9)
    ids = torch.from_numpy(rng.integers(0, 40, (64, 5)))
    req = torch.arange(64) + mob.requester_id
    for part in (True, False):
        for r in range(12):
            host = tmob.membership_step(mob, r, req, ids, mask, base, level, 3,
                                        partitionable=part)
            card = tmob.membership_step(mob, r, req.to(cuda_device), ids.to(cuda_device),
                                        mask.to(cuda_device), base.to(cuda_device),
                                        level.to(cuda_device), 3, partitionable=part)
            for h, c in zip(host, card):
                assert torch.equal(c.cpu(), h)
            drained = tmob.contributor_discharge(level.to(cuda_device), card[0], 1.5, 30.0,
                                                 True, mob.contributor_capacity_j)
            assert torch.equal(drained.cpu(), tmob.contributor_discharge(
                level, host[0], 1.5, 30.0, True, mob.contributor_capacity_j))
