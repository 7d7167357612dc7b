"""Every collective the port issues, through one entry point: the
counterpart of reading a compiled step's collectives out of its HLO.

``all_reduce`` and ``broadcast`` take the mesh axis they run over
(``model``: TensorParallel, TrainPlan.gather; ``data``: DataParallel, the
1-bit sync) and, in every run, add one call and the tensor's payload
bytes to that op's and axis's count (``counts()``, ``zero_counts()``), as
the kernel wrappers count their launches.

Inside a ``recording()`` scope (a context variable, like
sharding.tensor_parallel) a call is recorded as (op, axis, dtype, numel)
and returns its tensor untouched, without any process group: the dry run
(launch/dryrun.py) runs a rank's step on fake tensors under it, and needs
no ``init_process_group``. ``Recorder.summary()`` gives repro's keys
(hlo_analysis.collective_bytes): per op {"bytes", "count"}, all-reduce
bytes x 2 (a ring's reduce-scatter and all-gather phases move ~2 bytes a
byte of payload), "total_bytes"; plus "payload_bytes" (the tensors'
bytes) per op and in all, and the same per mesh axis under "by_axis".
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch

# repro's op names (hlo_analysis._COLL_OPS), then the port's own
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
       "broadcast")
# wire bytes a byte of payload (repro's ring factor for all-reduce)
WIRE_FACTOR = {"all-reduce": 2}

_COUNTS: dict[tuple[str, str], dict[str, int]] = {}


def counts() -> dict:
    """{op: {axis: {"calls", "bytes"}}}: the collectives issued since the
    last ``zero_counts()``, their payload bytes (a tensor's numel x element
    size) per op and mesh axis."""
    out: dict = {}
    for (op, axis), c in sorted(_COUNTS.items()):
        out.setdefault(op, {})[axis] = dict(c)
    return out


def zero_counts() -> None:
    _COUNTS.clear()


def _count(op: str, axis: str, x: torch.Tensor) -> None:
    c = _COUNTS.setdefault((op, axis), {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += x.numel() * x.element_size()


@dataclass
class Recorder:
    """The collectives a step would issue: (op, axis, dtype, numel) each."""
    calls: list = field(default_factory=list)

    def summary(self) -> dict:
        out = {op: {"bytes": 0, "count": 0, "payload_bytes": 0} for op in OPS}
        out["by_axis"] = {}
        payload = 0
        for op, axis, dtype, numel in self.calls:
            nbytes = numel * dtype.itemsize
            wire = nbytes * WIRE_FACTOR.get(op, 1)
            payload += nbytes
            out[op]["bytes"] += wire
            out[op]["count"] += 1
            out[op]["payload_bytes"] += nbytes
            a = out["by_axis"].setdefault(axis, {"bytes": 0, "count": 0, "payload_bytes": 0})
            a["bytes"] += wire
            a["count"] += 1
            a["payload_bytes"] += nbytes
        out["total_bytes"] = sum(out[op]["bytes"] for op in OPS)
        out["payload_bytes"] = payload
        return out


_RECORDER: contextvars.ContextVar = contextvars.ContextVar("collectives_recorder",
                                                           default=None)


@contextlib.contextmanager
def recording():
    """Record the enclosed collectives instead of issuing them -> the
    Recorder. The scope is the calling thread's and restores the one it
    replaced."""
    rec = Recorder()
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def _recorded(op: str, axis: str, x: torch.Tensor) -> bool:
    rec = _RECORDER.get()
    if rec is None:
        return False
    rec.calls.append((op, axis, x.dtype, x.numel()))
    return True


def all_reduce(x: torch.Tensor, *, axis: str, group=None) -> torch.Tensor:
    """Sum ``x`` in place over ``group`` (None: the world), the ranks of
    mesh axis ``axis`` -> ``x``."""
    if _recorded("all-reduce", axis, x):
        return x
    import torch.distributed as dist
    _count("all-reduce", axis, x)
    dist.all_reduce(x, group=group)
    return x


def broadcast(x: torch.Tensor, *, src: int, axis: str, group=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group``, in place
    -> ``x``."""
    if _recorded("broadcast", axis, x):
        return x
    import torch.distributed as dist
    _count("broadcast", axis, x)
    dist.broadcast(x, src=src, group=group)
    return x
