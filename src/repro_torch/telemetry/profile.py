"""Profiling hooks: ``torch.profiler`` around a block and the program-cost
recorder (port of ``repro.telemetry.profile``).

* :func:`maybe_torch_profiler` (the reference's ``maybe_jax_profiler``)
  runs ``torch.profiler.profile`` around the block when ``trace_dir`` is
  set, CPU activity plus CUDA on the card, and writes a Chrome/TensorBoard
  trace (``*.pt.trace.json``) into ``trace_dir``.  A profiler that fails to
  *start* is logged and the block runs untraced; nothing else is caught.
* :func:`record_program_cost` (the reference's ``jit_hlo_stats``, which
  compiled the program for XLA's cost analysis) installs a
  :class:`ProgramCost` for the block: each hand-written kernel's op charges
  its cost (``repro_torch.kernels.common.costed``), and the plain-torch
  products are counted apart through ``torch.utils.flop_counter``.
  :func:`program_cost_stats` turns the recorder into ``hlo_stats``.

Both stay on the host: a traced run computes the same bits as an untraced
one.  Under either, each kernel op runs inside a ``record_function`` range
named ``repro_torch::<kernel>``, which a profiler records.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels.common import current_cost_sink, install_cost_sink
from repro_torch.launch.hlo_stats import cost_summary, memory_summary

log = logging.getLogger(__name__)


@contextmanager
def maybe_torch_profiler(trace_dir: Optional[str], device=None):
    """``torch.profiler.profile`` around the block when ``trace_dir`` is
    set (CUDA activity too when ``device`` is a GPU), its trace written into
    ``trace_dir`` when the block ends; a plain no-op otherwise.  Yields the
    profiler (None when off)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir))
    try:
        prof.start()
    except Exception as exc:  # pragma: no cover - environment-dependent
        log.warning("torch profiler failed to start (%s); continuing untraced", exc)
        yield None
        return
    # with no recorder installed, the ops still run in their named ranges
    ranges = current_cost_sink() is None
    if ranges:
        install_cost_sink(_RANGES)
    try:
        yield prof
    finally:
        if ranges:
            install_cost_sink(None)
        prof.stop()


class _RangeSink:
    """Charges nothing: runs each kernel op in its ``repro_torch::<kernel>``
    range while a profiler records and no recorder is installed."""

    def run(self, name, cost, fn, args, kwargs):
        with torch.profiler.record_function(f"repro_torch::{name}"):
            return fn(*args, **kwargs)


_RANGES = _RangeSink()


class ProgramCost:
    """The sums of the kernel ops' costs over a span, per kernel, and the
    plain-torch products' flops (``torch_matmul_flops``).  Installed by
    :func:`record_program_cost`."""

    def __init__(self):
        self.per_kernel: dict = {}
        self.torch_matmul_flops = 0

    def run(self, name: str, cost: dict, fn, args, kwargs):
        """Charge ``cost`` to kernel ``name`` and run the op outside the
        flop counter, so a twin's own products stay out of the plain-torch
        count on the CPU as the kernel's do on the card.  The products an
        op forms in plain torch beside its kernel (its cost's
        ``torch_matmul_flops``) go to the plain-torch count, on either
        device."""
        cost = dict(cost)
        self.torch_matmul_flops += cost.pop("torch_matmul_flops", 0)
        acc = self.per_kernel.setdefault(name, dict.fromkeys(cost, 0))
        for key, value in cost.items():
            acc[key] += value
        with _disable_current_modes(), \
                torch.profiler.record_function(f"repro_torch::{name}"):
            return fn(*args, **kwargs)


@contextmanager
def record_program_cost():
    """Install a :class:`ProgramCost` for the block (yielded), with the
    plain-torch products counted under a ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    flop_mode = FlopCounterMode(display=False)
    rec = ProgramCost()
    prev = install_cost_sink(rec)
    try:
        with flop_mode:
            yield rec
    finally:
        install_cost_sink(prev)
        rec.torch_matmul_flops += int(flop_mode.get_total_flops())


def program_cost_stats(rec: ProgramCost, *, staged_bytes: int, carry_bytes: int,
                       device, peak_bytes: Optional[int] = None) -> dict:
    """``hlo_stats`` of a recorded span: :func:`cost_summary` of ``rec``
    and its ``memory`` (:func:`memory_summary`)."""
    stats = cost_summary(rec)
    stats["memory"] = memory_summary(staged_bytes, carry_bytes, device, peak_bytes)
    return stats
