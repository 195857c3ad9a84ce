"""Host-side timing spans: ``Span`` records on a per-run ``Timeline``
(port of ``repro.telemetry.spans``).

The engines' cost centers are host-visible walls: shard staging,
quantize/dequant packing, the round loop, result unpacking, the loop
engine's AES-CTR transport.  The instrument is a plain
``time.perf_counter`` stack that records nothing the simulation reads
(observation never changes the outcome).  A span around device work is
closed after a device sync by the engine that opens it, so its wall
covers the work and not only its enqueue.

Span-name vocabulary used by the engines (``Timeline.totals()`` keys):

===================  =====================================================
``stage``            host-side handshake + tensor staging (fleet)
``quantize_pack``    int8 round-state quantization (nested in ``stage``)
``program``          the fleet's round loop
``unpack``           device->host result unpacking + write-back
``dequant_unpack``   int8->fp32 write-back dequant (nested in ``unpack``)
``handshake``        loop-engine contract signing + key exchange
``transport``        loop-engine AES-CTR collect of one round's updates
``fit``              loop-engine requester fit of one round
``refresh``          loop-engine contributor refresh of one round
===================  =====================================================
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One timed region.  ``t0``/``dur`` are seconds relative to the
    owning Timeline's epoch; ``dur < 0`` marks a span still open."""

    name: str
    t0: float
    dur: float = -1.0
    depth: int = 0
    parent: Optional[int] = None   # index into Timeline.spans
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


class Timeline:
    """An append-only list of (possibly nested) spans for one run.

    Recording is always on in the engines: a span costs two
    ``perf_counter`` reads and one small object.  Use :meth:`span` as a
    context manager for small regions, or :meth:`begin`/:meth:`finish`
    around regions that are awkward to indent.
    """

    def __init__(self):
        self.spans: List[Span] = []
        self._stack: List[int] = []
        self._epoch = time.perf_counter()

    def begin(self, name: str, **attrs) -> int:
        """Open a span; returns its index for :meth:`finish`."""
        idx = len(self.spans)
        self.spans.append(Span(
            name=name, t0=time.perf_counter() - self._epoch,
            depth=len(self._stack),
            parent=self._stack[-1] if self._stack else None,
            attrs=dict(attrs)))
        self._stack.append(idx)
        return idx

    def finish(self, idx: int) -> None:
        """Close the span opened by :meth:`begin` (strictly LIFO)."""
        if not self._stack or self._stack[-1] != idx:
            raise RuntimeError(
                f"span {idx} is not the innermost open span "
                f"(stack: {self._stack})")
        self._stack.pop()
        sp = self.spans[idx]
        sp.dur = time.perf_counter() - self._epoch - sp.t0

    @contextmanager
    def span(self, name: str, **attrs):
        idx = self.begin(name, **attrs)
        try:
            yield self.spans[idx]
        finally:
            self.finish(idx)

    def totals(self) -> Dict[str, float]:
        """Summed duration (s) per span name: the wall-clock breakdown.
        Nested spans count under their own name AND inside their
        parent's duration (``quantize_pack`` is a sub-slice of ``stage``,
        not additive with it)."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            if sp.dur >= 0:
                out[sp.name] = out.get(sp.name, 0.0) + sp.dur
        return out

    def total(self, name: str) -> float:
        return self.totals().get(name, 0.0)
