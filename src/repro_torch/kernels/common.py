"""Shared device and argument policy of the port's kernels.

``resolve_device`` is how every entry point picks its device: ``cuda``
unless the caller names one, and an error when no GPU is present and the
caller named none (the port never carries on quietly on the CPU).  The
``ops`` modules dispatch through ``use_twin``: a CPU tensor goes to the
plain PyTorch twin, a CUDA tensor to the hand-written kernel, anything
else raises.  ``plain_twins`` is the caller's explicit choice of the twins
on the card too (``ExecutionSpec(use_pallas=False)``); it is never entered
on a failure, so a kernel that fails to build or launch still raises.

``costed`` marks each public op of the ``ops`` modules with the work of one
call, a function of its arguments' shapes (flops, bytes accessed,
transcendentals, and whether it launches; an op that also forms products
in plain torch beside its kernel gives their flops as
``torch_matmul_flops``, which count with the plain-torch products, not
with the kernel's work).  The cost is charged at the
dispatch, before the choice between twin and kernel, so the CPU's twins and
the card's kernels report the same numbers for the same world.  Nothing is
charged unless a recorder is installed (``install_cost_sink``: the
program-cost recorder of ``repro_torch.telemetry.profile``).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

# True inside ``plain_twins()``: the ops run their twins on CUDA tensors
_PLAIN_TWINS = contextvars.ContextVar("repro_torch_plain_twins", default=False)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU, which must
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host")
        return torch.device("cuda")
    return torch.device(device)


def check_interpret(interpret) -> None:
    """Pallas interpret mode has no counterpart in the port: the engines
    take the reference's ``interpret`` argument and accept only None."""
    if interpret is not None:
        raise ValueError(
            f"interpret={interpret!r}: Pallas interpret mode has no counterpart in "
            "the port; pass interpret=None, and use_pallas=False to run the plain "
            "PyTorch twins instead of the kernels")


@contextlib.contextmanager
def plain_twins():
    """Inside the block every op runs its plain PyTorch twin, on the card
    too: the selection ``use_pallas=False`` makes for a whole run."""
    token = _PLAIN_TWINS.set(True)
    try:
        yield
    finally:
        _PLAIN_TWINS.reset(token)


def plain_twins_selected() -> bool:
    """True inside :func:`plain_twins`."""
    return _PLAIN_TWINS.get()


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain twin), False for a CUDA tensor
    (kernel); raises for any other device."""
    if t.is_cuda:
        return False
    if t.is_cpu:
        return True
    raise ValueError(f"unsupported device {t.device} (cpu or cuda)")


def use_twin(t: torch.Tensor) -> bool:
    """True where an op on ``t`` runs its plain twin: a CPU tensor, or a
    CUDA tensor inside :func:`plain_twins`.  False where it launches its
    kernel; raises for any other device."""
    return is_cpu(t) or _PLAIN_TWINS.get()


def check_args(*specs) -> int:
    """Validate the tensor arguments of one launch before their pointers
    are passed on.  Each spec is ``(name, tensor, dtype, shape)``, with
    ``shape`` None for any shape.  Every tensor must have its dtype and
    shape, be contiguous, and lie on one CUDA device.  Returns that
    device's index.

    Every argument's dtype, shape and contiguity are checked before it is
    known that the first one is a CUDA tensor, so a tensor that breaks them
    is refused with that reason on the CPU too.  One call per launch, and
    no ``torch.device`` is built: the checks read ``Tensor.get_device()``,
    which is -1 off the GPU.
    """
    index = first = None
    for name, t, dtype, shape in specs:
        if t.dtype is not dtype:
            raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)} "
                             f"(got {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if first is None:
            index, first = t.get_device(), t
        elif t.get_device() != index:
            raise ValueError(f"{name} must be a CUDA tensor on {first.device} "
                             f"(got {t.device})")
    if not first.is_cuda:
        raise ValueError(f"{specs[0][0]} must be a CUDA tensor (got {first.device})")
    return index


def _stream_handle(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# current_stream(index) -> the raw handle (an int) of PyTorch's current
# stream on CUDA device ``index``: the one a ``torch.cuda.stream(s)`` block
# sets.  PyTorch's own accessor returns it without building the
# ``torch.cuda.Stream`` object that ``torch.cuda.current_stream`` makes on
# every call (Triton's launcher reads it the same way); a build without it
# (the CPU-only one) gets the public call.
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or _stream_handle


# the installed cost recorder (None: nothing is charged).  A module global,
# not a context variable: autograd runs a CUDA backward on a thread of its
# own, whose ops must charge the same recorder.
_COST_SINK = None


def install_cost_sink(sink):
    """Install ``sink`` (an object with ``run(name, cost, fn, args,
    kwargs)``) as the recorder every costed op charges; returns the one
    it replaces.  None uninstalls."""
    global _COST_SINK
    prev, _COST_SINK = _COST_SINK, sink
    return prev


def current_cost_sink():
    """The installed recorder, or None."""
    return _COST_SINK


def op_cost(flops: int = 0, bytes_accessed: int = 0, transcendentals: int = 0,
            launches: int = 1) -> dict:
    """The work of one op call: integers, and ``launches`` 0 where the
    kernel has nothing to do and launches nothing."""
    return {"launches": int(launches), "flops": int(flops),
            "bytes_accessed": int(bytes_accessed), "transcendentals": int(transcendentals)}


def costed(name: str, cost_of):
    """Decorate an op as the entry of kernel ``name`` (a key of
    ``repro_torch.kernels.launch_counts``): with a recorder installed, each
    call charges ``cost_of(*args, **kwargs)`` to it and runs inside the
    recorder (which keeps the twin's own products out of its count of the
    plain-torch ones)."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            sink = _COST_SINK
            if sink is None:
                return fn(*args, **kwargs)
            return sink.run(name, cost_of(*args, **kwargs), fn, args, kwargs)
        return op
    return wrap
