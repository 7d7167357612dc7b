"""Scheduling primitives for the continuous-batching slot engine (a copy of
repro/serving/scheduler.py, so that this package imports nothing from
repro — importing ``repro.serving.scheduler`` would run
``repro/serving/__init__.py``, which imports the JAX engine).

Pieces kept separate from the engine's torch plumbing so the policy is
testable in pure Python:

  * length buckets — queued prompts are padded up to a small set of bucket
    lengths, so prefill runs at O(#buckets * log max_batch) shapes;
  * ``FifoScheduler`` — the admission policy: serve the oldest queued request
    first, and batch it with every other queued request that shares its
    length bucket, up to the number of free slots;
  * ``SloScheduler`` — SLO-class-aware admission (interactive > standard >
    batch) with a hard anti-starvation bound: once the oldest queued request
    has waited ``starvation_limit`` ticks it anchors the next group no
    matter its class, so no request waits forever behind a stream of
    higher-priority arrivals;
  * ``AdmissionError`` — the structured per-request rejection the engine
    raises at ``add_request`` time (and the HTTP front door maps to a 400),
    instead of letting an oversized prompt blow up ``bucket_len`` inside
    the tick loop and take the whole engine down;
  * ``accept_wave`` — the speculative-decoding accept rule;
  * ``poisson_workload`` / ``prefix_workload`` — reproducible mixed-length
    Poisson arrival streams for benchmarks and tests.
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
    # per-token observer: called with each generated token id, then None
    # when the request finishes — the HTTP front door's streaming seam.
    # Exceptions are swallowed by the engine (a slow client must never
    # take the tick loop down).
    stream: object = dataclasses.field(default=None, compare=False,
                                       repr=False)


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
    runs at O(log max_batch) group sizes instead of one per size."""
    p = 1
    while p < n:
        p *= 2
    return p


class FifoScheduler:
    """FIFO admission with same-bucket batching.

    ``select`` never reorders across the queue head: the group is always
    anchored on the oldest waiting request, so no request can be starved by
    a stream of easier-to-batch arrivals.

    ``metrics`` (a telemetry MetricsRegistry, or None) makes admission
    decisions observable: how often select runs, how big the groups it
    forms are, and how many bucket-incompatible requests each decision
    left waiting — the "why is my request queued" counter.
    """

    def __init__(self, buckets: tuple[int, ...], metrics=None):
        self.buckets = buckets
        self._selects = self._group_size = self._left_waiting = None
        if metrics is not None:
            self._selects = metrics.counter(
                "sched_selects_total", "admission decisions taken")
            self._group_size = metrics.histogram(
                "sched_group_size", "requests batched per admission group",
                buckets=tuple(float(2 ** i) for i in range(11)))
            self._left_waiting = metrics.counter(
                "sched_left_waiting_total",
                "queued requests an admission decision could not batch "
                "(wrong bucket or no free slot)")

    def select(self, queue: list[Request], n_free: int,
               length_of=None, clock: int = 0) -> list[Request]:
        """Pick up to n_free requests sharing the queue head's bucket.

        length_of maps a request to the length that gets padded at prefill
        — len(prompt) by default; the prefix-cached engine passes the
        *un-cached suffix* length, so requests whose prompts differ wildly
        but share a cached header still batch together. ``clock`` (the
        engine's tick count) is unused here; SLO-aware subclasses age
        requests against it."""
        if not queue or n_free <= 0:
            return []
        length_of = length_of or (lambda r: len(r.prompt))
        head_bucket = bucket_len(length_of(queue[0]), self.buckets)
        group = [r for r in queue
                 if bucket_len(length_of(r), self.buckets) == head_bucket]
        group = group[:n_free]
        self._note(queue, group)
        return group

    def _note(self, queue, group):
        if self._selects is not None:
            self._selects.inc()
            if group:
                self._group_size.observe(len(group))
            self._left_waiting.inc(len(queue) - len(group))


class SloScheduler(FifoScheduler):
    """SLO-class-aware admission with a hard starvation bound.

    Selection anchors on the best (class rank, arrival) request — an
    ``interactive`` arrival jumps a queue of ``batch`` work — and fills the
    rest of the group with same-bucket requests in the same priority
    order. Starvation-freedom is absolute, not probabilistic: whenever the
    queue head (always the globally oldest request — the engine appends in
    arrival order) has waited more than ``starvation_limit`` ticks, it
    anchors the group regardless of class and survives truncation at the
    front, so the oldest request makes progress at least once per
    ``starvation_limit``-tick window no matter the arrival pattern.

    With every request in one class this degenerates to FifoScheduler
    exactly (anchor = queue head, group in queue order), which is what
    keeps the token-parity matrix valid under the default config.
    """

    def __init__(self, buckets: tuple[int, ...], metrics=None,
                 starvation_limit: int = 64):
        super().__init__(buckets, metrics)
        if starvation_limit < 1:
            raise ValueError(
                f"starvation_limit must be >= 1, got {starvation_limit}")
        self.starvation_limit = starvation_limit
        self._starved = None
        if metrics is not None:
            self._starved = metrics.counter(
                "sched_starvation_anchors_total",
                "admission groups anchored on an over-age request "
                "(class priority overridden to guarantee progress)")

    def select(self, queue: list[Request], n_free: int,
               length_of=None, clock: int = 0) -> list[Request]:
        if not queue or n_free <= 0:
            return []
        length_of = length_of or (lambda r: len(r.prompt))
        if clock - queue[0].arrival > self.starvation_limit:
            anchor = queue[0]
            if self._starved is not None:
                self._starved.inc()
        else:
            # min is stable, so arrival ties keep queue (= arrival) order
            anchor = min(queue, key=lambda r: (slo_rank(r.slo), r.arrival))
        ab = bucket_len(length_of(anchor), self.buckets)
        rest = [r for r in queue if r is not anchor
                and bucket_len(length_of(r), self.buckets) == ab]
        rest.sort(key=lambda r: (slo_rank(r.slo), r.arrival))
        group = [anchor] + rest[:n_free - 1]
        self._note(queue, group)
        return group


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


def poisson_workload(n: int, *, rate: float, prompt_lens=(8, 12, 16),
                     max_new=(4, 16), vocab: int = 256, seed: int = 0):
    """n requests with exponential inter-arrival gaps (arrival unit = one
    decode step), mixed prompt lengths, and uniform max_new draws.

    Returns [(arrival_step, prompt, max_new)] sorted by arrival.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.choice(prompt_lens))
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        mn = int(rng.integers(max_new[0], max_new[1] + 1))
        out.append((int(t), prompt, mn))
    return out


def prefix_workload(n: int, *, header_len: int = 128,
                    suffix_lens=(8, 12, 16), rate: float = 0.5,
                    max_new=(8, 16), vocab: int = 256, seed: int = 0,
                    token_source=None):
    """The multi-user chat shape: every prompt = one shared ``header_len``
    token header (system prompt / few-shot block) + a short unique suffix,
    Poisson arrivals. This is the workload the radix prefix cache converts
    from O(prompt) to O(suffix) prefill — after the first request publishes
    the header blocks, later arrivals re-prefill only their suffix.

    token_source(rng, n) -> (n,) int32 overrides the uniform token draw
    (benchmarks pass a generator matched to their trained model's data
    distribution so greedy argmax margins stay decisive).

    Returns [(arrival_step, prompt, max_new)] sorted by arrival.
    """
    rng = np.random.default_rng(seed)
    draw = token_source or (
        lambda rng_, k: rng_.integers(0, vocab, k).astype(np.int32))
    header = draw(rng, header_len)
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        slen = int(rng.choice(suffix_lens))
        suffix = draw(rng, slen)
        mn = int(rng.integers(max_new[0], max_new[1] + 1))
        out.append((int(t), np.concatenate([header, suffix]), mn))
    return out
