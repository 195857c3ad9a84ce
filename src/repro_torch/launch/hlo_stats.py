"""Work counts of a program of the port (port of ``repro.launch.hlo_stats``).

The reference reads its program's flops and bytes from XLA's cost analysis
of the compiled HLO.  The port has no compiled program: its work is the
hand-written kernels' and the plain-torch products'.  Each kernel entry of
``repro_torch.kernels.*.ops`` carries a cost function of its arguments'
shapes (``repro_torch.kernels.common.costed``), and the program-cost
recorder (``repro_torch.telemetry.profile.ProgramCost``) sums them per
kernel over a run.  Costs are charged at the op's dispatch, so the CPU's
twins and the card's kernels count the same integers for the same world.

* :func:`cost_summary` keeps the reference's keys (``flops``,
  ``bytes_accessed``, ``transcendentals``): the hand-written kernels' sums
  over the recorded span, beside ``per_kernel`` and
  ``torch_matmul_flops`` (the plain-torch products, counted apart).
* :func:`memory_summary` gives the staged state, the round carry and, on
  the card, the peak allocation over the span.

``collective_bytes`` parses post-SPMD HLO text; it has no meaning on one
card and comes with the mesh tooling.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

COST_KEYS = ("flops", "bytes_accessed", "transcendentals")


def cost_summary(counter) -> Dict[str, object]:
    """The reference's three keys, summed over the kernels ``counter`` (a
    ``ProgramCost``) recorded, plus ``per_kernel`` (each kernel's launches,
    flops, bytes and transcendentals over the span) and
    ``torch_matmul_flops``.  All integers."""
    per_kernel = {name: dict(c) for name, c in sorted(counter.per_kernel.items())}
    out: Dict[str, object] = {k: sum(c[k] for c in per_kernel.values()) for k in COST_KEYS}
    out["torch_matmul_flops"] = int(counter.torch_matmul_flops)
    out["per_kernel"] = per_kernel
    return out


def memory_summary(staged_bytes: int, carry_bytes: int,
                   device: torch.device, peak_bytes: Optional[int] = None) -> Dict[str, int]:
    """``staged_bytes`` (the round state staged before the loop),
    ``carry_bytes`` (the round carry the loop passes on) and, on the card,
    ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the span."""
    out = {"staged_bytes": int(staged_bytes), "carry_bytes": int(carry_bytes)}
    if torch.device(device).type == "cuda" and peak_bytes is not None:
        out["peak_bytes"] = int(peak_bytes)
    return out
