"""CUDA graphs for the serving engine's decode tick and speculative wave:
the port's counterpart of repro's one jitted call per tick
(repro/serving/engine.py:1-5) and one jitted launch per speculative wave
(:53-57, repro/serving/spec.py:151).

A ``StepGraph`` wraps one function of no arguments, ``fn() -> tuple of
tensors``, that reads its inputs from static device buffers the engine
fills before each call (tokens, request ids, steps, base lengths) and
updates the pool in place. On a CUDA device the first call

  1. runs ``fn`` once eagerly on a side stream (the warm-up: the kernels'
     nvcc builds and ``cudaFuncSetAttribute`` calls, cuBLAS's handles and
     workspaces, every shape's first launch happen here, outside the
     graph), then puts back the state tensors it was given (the pool's
     lengths), so the warm-up leaves the pool as it found it: its writes
     sit at positions at or past each length, which no read sees, and the
     replay that follows writes the same values there;
  2. captures ``fn`` into one ``torch.cuda.CUDAGraph`` on that stream;

and every call, the first included, is then one ``graph.replay()``, whose
outputs are the graph's own tensors (read them before the next call). A
capture that fails raises; nothing falls back to eager on a card. On the
CPU ``fn`` runs eagerly on the same static buffers at every call, so the
CPU tests exercise the same in-place plumbing.

Launch counts. Each kernel wrapper adds one to its ``.launches`` where it
launches its kernel, in Python: during a capture that code runs once and
nothing launches, and a replay runs no Python. So the runner counts, per
wrapper, what one capture added, takes the warm-up's and the capture's
additions back out (set-up, like the build), and adds the captured count on
every replay: a wrapper's count stays the number of its kernel's launches
on the path. The runner keeps the captured ``cudaGraph_t``
(``graph.raw_cuda_graph()``), so the counts one replay adds can be held to
the graph's own kernel nodes (chip_smoke.py does, on every graphed path),
and the warm-up's eager launches per wrapper in ``warmup``, so a device
trace of a run (the warm-up's kernels and every replayed node) can be held
to the counts too.

Nothing a graph holds may be rebound between calls: the caches' leaves,
``len`` among them, are written in place (serving/kvcache.py), and the
static inputs are filled with ``copy_``.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from repro_torch.kernels import COUNTED


def _counts() -> list[int]:
    return [w.launches for w in COUNTED]


class StepGraph:
    """One engine step (a decode tick or a speculative wave) as a CUDA graph
    on a card, eager on the CPU. ``keep``: the state tensors the warm-up
    must leave as it found them."""

    def __init__(self, fn: Callable[[], tuple], device: torch.device, *,
                 keep: list[torch.Tensor]):
        self.fn, self.device, self.keep = fn, torch.device(device), keep
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple | None = None
        self.per_replay: list[int] = []     # launches a replay adds, per wrapper
        self.warmup: list[int] = []         # the warm-up's eager launches, per wrapper
        self.replays = 0
        self.eager_calls = 0

    def __call__(self) -> tuple:
        if self.device.type != "cuda":
            self.eager_calls += 1
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for w, n in zip(COUNTED, self.per_replay):
            w.launches += n
        self.replays += 1
        return self.outputs

    def _capture(self) -> None:
        # no garbage collection in the warm-up and the capture: an earlier
        # engine's graph freed there (engines hold their graphs in a
        # reference cycle) would destroy a graph mid-capture, which CUDA
        # refuses, and the capture would fail
        enabled = gc.isenabled()
        gc.disable()
        try:
            self._warm_and_capture()
        finally:
            if enabled:
                gc.enable()

    def _warm_and_capture(self) -> None:
        before = _counts()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            saved = [t.clone() for t in self.keep]
            self.fn()                                      # the warm-up
            for t, s in zip(self.keep, saved):
                t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        warm = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)      # its nodes stay readable
        with torch.cuda.graph(graph, stream=side):
            outputs = self.fn()
        graph.instantiate()
        self.per_replay = [c - w for c, w in zip(_counts(), warm)]
        self.warmup = [w - b for w, b in zip(warm, before)]
        for w, n in zip(COUNTED, before):
            w.launches = n
        self.graph, self.outputs = graph, outputs
