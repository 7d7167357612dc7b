"""Scheduling primitives for the continuous-batching slot engine (a copy of
repro/serving/scheduler.py, so that this package imports nothing from
repro — importing ``repro.serving.scheduler`` would run
``repro/serving/__init__.py``, which imports the JAX engine).

  * length buckets — queued prompts are padded up to a small set of bucket
    lengths;
  * ``FifoScheduler`` — serve the oldest queued request first, batched with
    every other queued request that shares its length bucket, up to the
    number of free slots;
  * ``AdmissionError`` — the structured per-request rejection the engine
    raises at ``add_request`` time;
  * ``accept_wave`` — the speculative-decoding accept rule.

The SLO scheduler and the workload generators come with the slice that
uses them (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# deadline classes, best-first: admission order is (class rank, arrival).
# The names are the front door's public vocabulary; rank is positional.
SLO_CLASSES = ("interactive", "standard", "batch")


def slo_rank(slo: str) -> int:
    """Class -> priority rank (lower = served first); raises on unknowns."""
    try:
        return SLO_CLASSES.index(slo)
    except ValueError:
        raise AdmissionError(
            "bad_slo", f"unknown SLO class {slo!r}",
            slo=slo, allowed=list(SLO_CLASSES)) from None


class AdmissionError(ValueError):
    """A request the engine refuses to queue, as structured data.

    Subclasses ValueError so pre-existing ``pytest.raises(ValueError)``
    call sites keep passing; carries a machine-readable ``code`` and
    ``detail`` dict so the HTTP front door can answer 400 with a body a
    client can branch on rather than a stringly-typed message.
    """

    def __init__(self, code: str, message: str, **detail):
        super().__init__(message)
        self.code = code
        self.detail = {k: v for k, v in detail.items()}

    def to_dict(self) -> dict:
        return {"error": {"code": self.code, "message": str(self),
                          "detail": self.detail}}


@dataclasses.dataclass
class Request:
    """One serving request; slot occupancy lives in the engine's slot table.

    ``rid`` stays the first field: list.remove falls back to dataclass
    ``__eq__``, and tuple comparison short-circuits on the always-unique
    rid before ever comparing the prompt arrays."""
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    # generation stops after a sampled token lands in this set (the token is
    # kept in out, EOS-style); empty = run to max_new
    stop_tokens: frozenset = frozenset()
    # deadline class (SLO_CLASSES) — FifoScheduler ignores it
    slo: str = "standard"
    # engine tick at which the request was queued (the scheduler's clock
    # for aging / starvation bounds)
    arrival: int = 0


def make_buckets(max_len: int, *, min_bucket: int = 8) -> tuple[int, ...]:
    """Powers of two from min_bucket up, capped at max_len (always included)."""
    buckets = []
    b = min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_len(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (prompts are validated against max at admission)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def pad_group(n: int) -> int:
    """Round a prefill group size up to a power of two so the prefill kernel
    compiles for O(log max_batch) group sizes instead of one per size."""
    p = 1
    while p < n:
        p *= 2
    return p


class FifoScheduler:
    """FIFO admission with same-bucket batching.

    ``select`` never reorders across the queue head: the group is always
    anchored on the oldest waiting request, so no request can be starved by
    a stream of easier-to-batch arrivals.
    """

    def __init__(self, buckets: tuple[int, ...]):
        self.buckets = buckets

    def select(self, queue: list[Request], n_free: int,
               length_of=None) -> list[Request]:
        """Pick up to n_free requests sharing the queue head's bucket.

        length_of maps a request to the length its prefill pads: the prompt
        length by default; the prefix-cached engine passes the un-cached
        suffix length, so prompts that share a cached header batch together."""
        if not queue or n_free <= 0:
            return []
        length_of = length_of or (lambda r: len(r.prompt))
        head_bucket = bucket_len(length_of(queue[0]), self.buckets)
        group = [r for r in queue
                 if bucket_len(length_of(r), self.buckets) == head_bucket]
        return group[:n_free]


def accept_wave(candidates, drafts) -> list[int]:
    """Speculative-decoding accept rule (pure policy).

    candidates: the k+1 tokens the request's own RNG stream emits from
    *target* logits at verify positions 0..k (candidates[j] is what the
    non-speculative engine would emit as the wave's j-th token, valid
    whenever drafts 0..j-1 were all accepted). drafts: the k draft
    proposals. Returns the wave's emitted tokens (1..k+1): the longest
    draft prefix that matches the candidates, then one correction token
    (first mismatch) or bonus token (all drafts held). Token-identity
    with sequential decoding is structural: every returned token IS a
    candidate, conditioned on an all-accepted history."""
    emitted = []
    for j, d in enumerate(drafts):
        emitted.append(int(candidates[j]))
        if emitted[-1] != int(d):
            return emitted
    emitted.append(int(candidates[len(drafts)]))
    return emitted
