"""Continuous-batching slot engine (port of repro/serving/engine.py: greedy,
sampled and speculative decoding, the FIFO and SLO schedulers, blocking,
chunked and interleaved prefill, the KV codecs on the contiguous and the
paged pool, the radix prefix cache, and telemetry).

A fixed pool of ``max_batch`` decode slots. Every tick decodes the whole
pool in one batched step, and requests flow through three states:

  queued -> admitted (prefill into a free slot) -> evicted (max_new / stop)

Admission happens between decode steps: finished requests free their slot
at the end of a tick and the scheduler prefills queued work into the gaps.
Prefill batches are padded to power-of-two length buckets and group sizes;
``seq_lens`` makes the padded prefill decode exactly as an unpadded one
(models/transformer.py), so greedy outputs match repro's engine. Free
slots ride through the decode step; their rows are computed and ignored.

Greedy decoding takes ``torch.argmax``, which returns the first maximum,
as ``jnp.argmax`` does. Sampling (``temperature > 0``) draws row r from its
request's own stream, fold_in(fold_in(PRNGKey(seed), rid), len(out)), with
JAX's bits (serving/sampling.py), so a request's tokens depend only on
(params, prompt, seed, rid) and equal repro's. The pool lives on the device
of ``params`` and is updated in place.

Speculative decoding (``spec_k > 0``) swaps the one-token tick for a
draft / verify wave (serving/spec.py): the binarized self-draft proposes
``spec_k`` tokens through the target's own cache, one float verify pass
scores all of them, and the engine keeps the longest prefix that matches
what each request's own stream emits from the target's logits, plus one
correction or bonus token (scheduler.accept_wave). Each token is picked
from the verify's logits where the plain engine picks from a decode's, so
the tokens equal the plain engine's where the two passes round the same
way: on the CPU they do (tests/test_torch_spec.py); on a card they can
differ, bf16 most, whose verify attends through the plain recurrence
(kernels/kv_decode.fused_decode_plain) where its decode takes the dot
attention, and cuBLAS rounds a verify at M = B(k + 1) unlike a decode at
M = B (ROADMAP B 1(a) routes the bf16 verify through a kernel). The
rollback is a per-slot length reset.
``spec_draft_impl`` picks the draft's packed product (B1 for "auto").

On a card each decode tick, and each speculative wave, is one CUDA graph
replay (serving/graphs.py; ``cuda_graphs=False`` runs them eagerly, for
comparison): the engine fills static device buffers (tokens, request ids,
steps, base lengths) and replays. Admission (prefill waves, the slot and
page scatters with their host sync), the host read of the picked tokens,
the accept rule, the rollback and the radix bookkeeping stay outside the
graph.

``kv_cache`` picks the pool's codec (bf16, int8, binary; serving/kvcache.py).
Two pool layouts (``kv_block_size``):

  0 (default)   slot-contiguous: each slot owns a (max_len, ...) region.
  > 0           paged: one shared block pool + per-slot block tables. With
                ``prefix_cache=True`` a radix tree over token blocks
                (serving/prefix.py) lets requests that share a prompt prefix
                share its physical blocks and prefill only their un-cached
                suffix.

Prefill. A blocking wave prefills a whole admission group before the
tick's decode, in one call (``prefill_chunk=0``: the flash kernel) or as
chunks of ``prefill_chunk`` tokens through the verify path
(``api.prefill_chunked``). With ``interleave=True`` an admitted group
becomes a prefill job: its slots are committed at once and assigned at
install, and each tick runs ``slices_per_tick`` slices of
``prefill_chunk`` (else the smallest bucket) tokens beside the decode
batch, each into the job's own transient cache at the pool's length and in
its codec (``api.prefill_slice``). The last slice's finish runs the head,
then the install shared with the blocking wave samples the first tokens and
writes the job's cache into the pool's tensors in place, so interleaved
tokens equal the chunked blocking engine's. A group with a cached prefix
(paged, prefix cache on) runs as one blocking suffix prefill, still
scheduled as a job. On a card a slice runs eagerly between two replays,
its tokens and lengths already on the device: no host sync inside a slice.
The decode tick and the speculative wave stay one replay each.

``scheduler="slo"`` admits by (SLO class, arrival) with a hard
``starvation_limit`` (serving/scheduler.py). ``telemetry=`` (a
serving/telemetry.Telemetry) records request spans, per-phase tick
histograms, queue wait, TTFT and ITL from host clocks and host integers
only: telemetry on and off launch the same kernels and replay the same
graphs, and TTFT / ITL are stamped after the tick's existing token read.
``add_request(stream=)`` delivers each token, then None at the finish, to
a callback (the HTTP front door's seam, launch/server.py).

Not ported yet, and refused with the ROADMAP item that ports them: meshes
(A9).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from repro_torch.kernels.ops import SPEC_DRAFT_IMPLS
from repro_torch.serving import kvcache as kvc
from repro_torch.serving import sampling
from repro_torch.serving.graphs import StepGraph
from repro_torch.serving.prefix import PrefixPool
from repro_torch.serving.scheduler import (AdmissionError, FifoScheduler, Request,
                                           SloScheduler, accept_wave, bucket_len,
                                           make_buckets, pad_group, slo_rank)

log = logging.getLogger("repro_torch.serving.engine")

# every ServeEngine.stats key, its type, and what it counts (repro's keys)
STATS_SCHEMA = {
    "decode_steps": (int, "engine ticks (decode steps or spec waves)"),
    "occupied_slot_steps": (int, "sum over ticks of occupied slots"),
    "prefills": (int, "admission prefill installs (blocking waves or completed "
                      "interleaved jobs)"),
    "prefill_jobs": (int, "interleaved prefill jobs started (0 with interleave off)"),
    "prefill_slices": (int, "interleaved prefill slices run alongside decode ticks"),
    "admitted": (int, "requests admitted into a slot"),
    "evictions": (int, "requests finished and evicted"),
    "generated_tokens": (int, "tokens emitted across all requests"),
    "prefilled_tokens": (int, "tokens run through prefill attention"),
    "cached_prompt_tokens": (int, "prompt tokens served from the radix prefix cache "
                                  "instead of prefill"),
    "spec_waves": (int, "speculative draft / verify waves run"),
    "spec_drafted": (int, "draft tokens proposed"),
    "spec_accepted": (int, "draft tokens accepted by verify"),
    "spec_draft_launches": (int, "device launches spent drafting: one per wave (a "
                                 "graph replay on a card)"),
    "kv_bytes": (int, "resident bytes of the preallocated KV pool"),
    "kv_bytes_per_device": (int, "per-device shard of kv_bytes (== kv_bytes on one "
                                 "device)"),
}


@dataclasses.dataclass
class _PagedSlot:
    """Host-side block accounting for one occupied slot (paged mode)."""
    plen: int                    # prompt tokens
    row: np.ndarray              # (n_pages,) physical ids, holes = n_blocks
    chain: list                  # radix nodes covering leading full blocks
    private: list                # physical blocks owned by this request


@dataclasses.dataclass
class _PrefillJob:
    """One admitted group prefilling a slice per tick (interleave mode).

    Its slots are committed (counted against free capacity) when the job
    starts but assigned at install, after the last slice; until then the
    prompts' K/V accumulate in a transient cache the size of one prefill
    batch, so decoding slots never see a partial prefill."""
    admitted: list               # [(Request, chain, blocks)]; contiguous: empty
    #                              chain and blocks
    toks: np.ndarray             # (gp, blen) right-padded suffix tokens
    lens: np.ndarray             # (gp,) true suffix lengths
    blen: int                    # padded bucket length
    gp: int                      # padded group size
    monolithic: bool             # one blocking call at its turn (a cached
    #                              prefix: its attention reads gathered context)
    arrays: dict | None          # paged group arrays (_paged_arrays)
    todo: int = 0                # slice coverage target (ceil(max lens / c) * c)
    pos: int = 0                 # prompt tokens already sliced
    caches: list | None = None   # transient prefill cache (allocated at the first
    #                              slice, dropped at install)
    h_last: torch.Tensor | None = None   # (gp, 1, d) taken last hidden states
    toks_dev: torch.Tensor | None = None  # toks and lens on the device: a slice
    lens_dev: torch.Tensor | None = None  # copies nothing from the host
    arrival: int = 0             # min member arrival (job aging)
    rank: int = 0                # min member SLO rank (job priority)
    t_start: float = 0.0         # admission-decision clock (telemetry)


class ServeEngine:
    def __init__(self, api, params, *, max_batch: int = 8, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0, min_bucket: int = 8,
                 attn_impl: str | None = None, kv_cache: str | None = None,
                 kv_block_size: int = 0, prefix_cache: bool = False,
                 n_blocks: int | None = None, spec_k: int = 0, spec_draft: str = "binary",
                 spec_draft_impl: str | None = None, mesh=None, prefill_chunk: int = 0,
                 telemetry=None, interleave: bool = False, slices_per_tick: int = 1,
                 scheduler: str = "fifo", starvation_limit: int = 64,
                 cuda_graphs: bool = True):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving (mesh) is not ported yet "
                                      "(ROADMAP A9)")
        if spec_draft_impl is not None and spec_draft_impl not in SPEC_DRAFT_IMPLS:
            raise ValueError(f"unknown spec_draft_impl {spec_draft_impl!r}: "
                             f"expected one of {SPEC_DRAFT_IMPLS}")
        overrides = {k: v for k, v in (("attn_impl", attn_impl), ("kv_cache", kv_cache),
                                       ("spec_draft_impl", spec_draft_impl))
                     if v is not None}
        if overrides:
            # model fns close over cfg, so a fresh api is the only seam
            from repro_torch.models import get_model
            api = get_model(api.cfg.replace(**overrides))
        if prefix_cache and not kv_block_size:
            raise ValueError("prefix_cache requires kv_block_size > 0 "
                             "(the radix cache shares paged blocks)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and spec_draft != "binary":
            raise ValueError(f"unknown speculative draft {spec_draft!r}: 'binary' (the "
                             "sign-packed self-draft) is the only draft; spec_k=0 "
                             "disables speculation")
        if spec_k and api.verify is None:
            raise ValueError(f"model {api.cfg.name!r} has no multi-token verify step "
                             "(MLA/SSM caches decode one token at a time); speculative "
                             "decoding requires a GQA KV pool (spec_k=0)")
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0 or self.prefill_chunk & (self.prefill_chunk - 1):
            raise ValueError(f"prefill_chunk must be 0 or a power of two (buckets are "
                             f"powers of two), got {prefill_chunk}")
        if self.prefill_chunk and api.prefill_chunked is None:
            raise ValueError(f"model {api.cfg.name!r} has no chunked prefill (GQA "
                             "families only); use prefill_chunk=0")
        self.interleave = bool(interleave)
        self.slices_per_tick = int(slices_per_tick)
        if self.interleave and self.slices_per_tick < 1:
            raise ValueError(f"slices_per_tick must be >= 1, got {slices_per_tick}")
        if self.interleave and api.prefill_slice is None:
            raise ValueError(f"model {api.cfg.name!r} has no prefill slice step (GQA "
                             "families only — the verify path); use interleave=False")
        if scheduler not in ("fifo", "slo"):
            raise ValueError(f"unknown scheduler {scheduler!r}: expected 'fifo' or 'slo'")
        self.api, self.params = api, params
        self.device = params["embed"]["table"].device
        self.max_batch, self.max_len = max_batch, max_len
        self._next_rid = 0
        self.queue: list[Request] = []
        self.results: dict[int, list[int]] = {}
        # host-side observer; None = no telemetry (on and off give the same
        # tokens and the same device work)
        self.tm = telemetry
        reg = telemetry.registry if telemetry is not None else None
        self.buckets = make_buckets(max_len, min_bucket=min_bucket)
        self.sched = (SloScheduler(self.buckets, metrics=reg, starvation_limit=starvation_limit)
                      if scheduler == "slo" else FifoScheduler(self.buckets, metrics=reg))
        # interleaved prefill: jobs in flight and the slots promised to them
        # (so two jobs never target the same future vacancy)
        self._jobs: list[_PrefillJob] = []
        self._committed = 0
        # the slice width: prefill_chunk when set, else the smallest bucket;
        # both powers of two, so slices tile every padded bucket
        self.slice_chunk = self.prefill_chunk or self.buckets[0]
        self.slots: list[Request | None] = [None] * max_batch
        self.next_tok = np.zeros((max_batch, 1), np.int32)
        self.block_size = int(kv_block_size)
        self.paged = self.block_size > 0
        self.prefix_on = bool(prefix_cache)
        if self.paged:
            bs = self.block_size
            self.n_pages = -(-max_len // bs)
            self.pool_len = self.n_pages * bs
            # by default the contiguous pool's capacity: sharing then only
            # frees blocks, so admission succeeds once refcount-0 tree
            # blocks are evicted
            self.n_blocks = n_blocks if n_blocks is not None else max_batch * self.n_pages
            self.caches = api.init_paged_cache(self.n_blocks, bs, max_batch, self.n_pages,
                                               device=self.device)
            self.pool = PrefixPool(self.n_blocks, bs, metrics=reg)
            self._pstate: dict[int, _PagedSlot] = {}
            self._codec = kvc.get_codec(api.cfg.kv_cache)
            self._hole_row = np.full((self.n_pages,), self.n_blocks, np.int32)
        else:
            self.pool_len = max_len
            self.caches = api.init_cache(max_batch, max_len, self.device)
        self.step_count = 0
        self.stats = {k: 0 for k in STATS_SCHEMA}
        self.stats["kv_bytes"] = kvc.kv_pool_bytes(self.caches)
        # one device until ROADMAP A9 shards the pool
        self.stats["kv_bytes_per_device"] = self.stats["kv_bytes"]
        if self.tm is not None:
            self.tm.engine_started(kv_bytes=self.stats["kv_bytes"],
                                   kv_bytes_per_device=self.stats["kv_bytes_per_device"],
                                   max_batch=max_batch,
                                   n_blocks=self.n_blocks if self.paged else None,
                                   byte_breakdown=kvc.kv_pool_byte_breakdown(self.caches))
        self.temperature = float(temperature)
        self._seed_key = sampling.prng_key(seed, device=self.device)
        self.spec_k = int(spec_k)
        # the step's static inputs: the graph reads them, the host fills
        # them with copy_ before each call
        z = dict(dtype=torch.int32, device=self.device)
        self._tok = torch.zeros((max_batch, 1), **z)
        self._rids = torch.zeros((max_batch,), **z)
        self._steps = torch.zeros((max_batch,), **z)
        self._base_lens = torch.zeros((max_batch,), **z)
        keep = [c["len"] for c in self.caches]
        if self.spec_k:
            from repro_torch.serving.spec import binarize_draft_params, make_spec_wave
            # the draft aliases every target tensor but the float FFNs'
            # packed bits and scales
            self.draft_params = binarize_draft_params(params, api.cfg)
            self._spec_wave = make_spec_wave(api, k=self.spec_k,
                                             temperature=self.temperature,
                                             seed_key=self._seed_key)
            fn = self._wave_fn
        else:
            fn = self._tick_fn
        self.graph = StepGraph(fn, self.device, keep=keep) if cuda_graphs else None
        self._step_fn = self.graph if cuda_graphs else fn

    def check_request(self, prompt_len: int, max_new: int,
                      slo: str = "standard") -> None:
        """Admission validation; raises AdmissionError (a ValueError) with
        repro's codes."""
        if prompt_len <= 0:
            raise AdmissionError("empty_prompt", "prompt must contain at least one token",
                                 prompt_len=int(prompt_len))
        if max_new < 1:
            raise AdmissionError("bad_max_new", f"max_new must be >= 1, got {max_new}",
                                 max_new=int(max_new))
        slo_rank(slo)
        if prompt_len > self.buckets[-1]:
            raise AdmissionError(
                "prompt_too_long",
                f"prompt length {prompt_len} exceeds the largest prefill "
                f"bucket ({self.buckets[-1]})",
                prompt_len=int(prompt_len), limit=int(self.buckets[-1]))
        if prompt_len + max_new + self.spec_k > self.max_len:
            extra = f" + spec_k ({self.spec_k})" if self.spec_k else ""
            raise AdmissionError(
                "too_long",
                f"prompt ({prompt_len}) + max_new ({max_new}){extra} exceeds max_len "
                f"({self.max_len})"
                + (": speculative waves write up to spec_k tokens of scratch K/V past "
                   "the last kept position" if self.spec_k else ""),
                prompt_len=int(prompt_len), max_new=int(max_new),
                spec_k=int(self.spec_k), max_len=int(self.max_len))

    def add_request(self, prompt, max_new: int = 16, stop_tokens=(),
                    slo: str = "standard", stream=None) -> int:
        """Queue one request; ``stream``, if given, is called with each
        generated token and then with None at the finish (on the engine's
        thread: it should only hand the token on)."""
        prompt = np.asarray(prompt, np.int32)
        self.check_request(len(prompt), max_new, slo)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new,
                                  stop_tokens=frozenset(int(t) for t in stop_tokens),
                                  slo=slo, arrival=self.step_count, stream=stream))
        if self.tm is not None:
            self.tm.request_added(rid, len(prompt))
        return rid

    def _stream_arrays(self, reqs) -> tuple[np.ndarray, np.ndarray]:
        """Each row's stream: (rid, len(out)), free / dummy rows (None) pinned
        to (0, 0); their tokens are never read."""
        rids = np.asarray([r.rid if r is not None else 0 for r in reqs], np.int32)
        steps = np.asarray([len(r.out) if r is not None else 0 for r in reqs], np.int32)
        return rids, steps

    def _sample(self, logits: torch.Tensor, reqs) -> np.ndarray:
        """reqs: one Request (or None for a free / dummy row) per row of
        logits. Greedy: the first maximum of each row. Sampled: row r draws
        from its request's stream fold_in(fold_in(seed, rid), len(out))."""
        rids, steps = self._stream_arrays(reqs)
        return sampling.pick(logits, self.temperature, self._seed_key, self._tensor(rids),
                             self._tensor(steps)).cpu().numpy()

    def _tick_fn(self) -> tuple:
        """One decode step over the pool from the static inputs, the pool
        updated in place: what a tick's graph holds. -> (tokens (B,),)."""
        logits, _ = self.api.decode(self.params, self.caches, self._tok)
        return (sampling.pick(logits, self.temperature, self._seed_key, self._rids,
                              self._steps),)

    def _wave_fn(self) -> tuple:
        """One speculative wave from the static inputs: what a wave's graph
        holds. -> (drafts (B, k + 1), candidates (B, k + 1))."""
        toks, cand, _ = self._spec_wave(self.params, self.draft_params, self.caches,
                                        self._tok, self._rids, self._steps, self._base_lens)
        return toks, cand

    def _fill(self, **host) -> None:
        """Copy host arrays into the static inputs of the same names."""
        for name, a in host.items():
            getattr(self, f"_{name}").copy_(torch.from_numpy(np.ascontiguousarray(a)))

    # -- slot lifecycle -----------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _notify(self, r: Request, tok):
        """Deliver one stream event (a token id, or None: finished) to the
        request's observer; an observer's failure never reaches the tick
        loop (a broken client is that client's problem)."""
        if r.stream is None:
            return
        try:
            r.stream(tok)
        except Exception:  # noqa: BLE001 - observer code is untrusted
            log.exception("stream callback failed for rid %d", r.rid)
            r.stream = None

    def _finish(self, slot: int):
        r = self.slots[slot]
        self.results[r.rid] = r.out
        self.slots[slot] = None
        self.stats["evictions"] += 1
        self._notify(r, None)
        if self.tm is not None:
            reason = ("stop" if r.out and r.out[-1] in r.stop_tokens
                      and len(r.out) < r.max_new else "max_new")
            self.tm.request_finished(r.rid, reason)
        if self.paged:
            st = self._pstate.pop(slot)
            self.pool.release(st.chain)
            self.pool.free_blocks(st.private)
            # clear the slot's table row and length now: the next decode must
            # not write through a stale row into freed (maybe reallocated)
            # blocks
            self.caches = kvc.paged_update_slots(
                self.caches, self._tensor(self._hole_row[None]),
                self._tensor(np.zeros((1,), np.int32)), self._tensor([slot]))

    def _append_token(self, slot: int, tok: int) -> bool:
        """Record one generated token; True if the request ended (max_new or
        stop token) and its slot was freed."""
        r = self.slots[slot]
        r.out.append(tok)
        self.next_tok[slot, 0] = tok
        self.stats["generated_tokens"] += 1
        self._notify(r, tok)
        if len(r.out) >= r.max_new or tok in r.stop_tokens:
            self._finish(slot)
            return True
        return False

    def _group_arrays(self, group):
        """Bucket-padded token/length arrays for one admission group."""
        blen = bucket_len(max(len(r.prompt) for r in group), self.buckets)
        gp = pad_group(len(group))
        toks = np.zeros((gp, blen), np.int32)
        lens = np.ones((gp,), np.int32)          # dummy rows: 1-token prompt
        for j, r in enumerate(group):
            toks[j, :len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        return toks, lens, blen, gp

    def _install_contig(self, group, blen, gp, logits, new, *, wave_t0=None,
                        t_admit=0.0):
        """Sample first tokens and scatter one prefilled group's caches into
        free slots, in place: the install the blocking wave and the
        interleaved job share, so their tokens match. ``wave_t0`` set: a
        blocking wave ran (its prefill_wave span); ``t_admit`` ends the
        requests' queue wait (the admission decision)."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        nxt = self._sample(logits, list(group) + [None] * (gp - len(group)))
        # dummy rows aim past the pool and are dropped by the scatter
        idx = np.full((gp,), self.max_batch, np.int64)
        idx[:len(group)] = free[:len(group)]
        self.caches = self.api.cache_insert(
            self.caches, new, torch.as_tensor(idx, device=self.device))
        self.stats["prefills"] += 1
        now = 0.0
        if self.tm is not None:
            now = self.tm.clock()
            if wave_t0 is not None:
                self.tm.prefill_wave(wave_t0, n_reqs=len(group), bucket=blen, now=now)
        for j, r in enumerate(group):
            slot = int(idx[j])
            self.slots[slot] = r
            self.stats["admitted"] += 1
            self.stats["prefilled_tokens"] += len(r.prompt)
            if self.tm is not None:
                self.tm.request_admitted(r.rid, slot=slot, prefilled_tokens=len(r.prompt),
                                         now=t_admit)
                self.tm.tokens_emitted(r.rid, 1, now=now)
            self._append_token(slot, int(nxt[j]))

    def _prefill(self, toks: np.ndarray, lens: np.ndarray):
        """One blocking prefill of a padded group at the pool's length:
        monolithic, or in chunks of ``prefill_chunk`` through the verify
        path."""
        batch = {"tokens": self._tensor(toks)}
        kw = dict(max_len=self.pool_len, seq_lens=self._tensor(lens))
        if self.prefill_chunk:
            return self.api.prefill_chunked(self.params, batch, chunk=self.prefill_chunk,
                                            **kw)
        return self.api.prefill(self.params, batch, **kw)

    def _admit(self):
        """Prefill queued requests into free slots (one group per bucket)."""
        if self.paged:
            self._admit_paged()
            return
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.queue:
            group = self.sched.select(self.queue, len(free), clock=self.step_count)
            if not group:
                break
            for r in group:
                self.queue.remove(r)
            toks, lens, blen, gp = self._group_arrays(group)
            t0 = self.tm.clock() if self.tm is not None else 0.0
            logits, new = self._prefill(toks, lens)
            self._install_contig(group, blen, gp, logits, new, wave_t0=t0, t_admit=t0)
            free = [i for i, r in enumerate(self.slots) if r is None]

    # -- paged admission (radix prefix cache) ---------------------------------

    def _select_paged(self, n_free: int):
        """Pick one paged admission group and allocate its blocks. Returns
        [(Request, chain, blocks)], dequeued, with matched chains pinned
        (maybe empty when the pool is exhausted)."""
        bs = self.block_size
        # each queued request's longest cached block prefix, under the tree
        # as earlier waves left it
        chains = {r.rid: self.pool.match(r.prompt, clock=self.step_count)
                  if self.prefix_on else [] for r in self.queue}
        group = self.sched.select(self.queue, n_free,
                                  length_of=lambda r: len(r.prompt) - len(chains[r.rid]) * bs,
                                  clock=self.step_count)
        if not group:
            return []
        # pin every candidate's chain before any allocation: eviction only
        # takes refcount-0 nodes, so no chain is reclaimed under the wave
        for r in group:
            self.pool.acquire(chains[r.rid])
        admitted, deferred = [], list(group)
        while deferred:
            r = deferred[0]
            chain = chains[r.rid]
            # + spec_k: verify waves write draft scratch K/V up to spec_k
            # positions past the last kept token
            need = -(-(len(r.prompt) + r.max_new - 1 + self.spec_k) // bs) - len(chain)
            blocks = self.pool.alloc(need, clock=self.step_count)
            if blocks is None:
                break                      # pool exhausted this wave
            deferred.pop(0)
            admitted.append((r, chain, blocks))
        for r in deferred:                 # not admitted: unpin
            self.pool.release(chains[r.rid])
        for r, _, _ in admitted:
            self.queue.remove(r)
        return admitted

    def _admit_paged(self):
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.queue:
            admitted = self._select_paged(len(free))
            if not admitted:
                break
            a = self._paged_arrays(admitted)
            t0 = self.tm.clock() if self.tm is not None else 0.0
            logits, new = self._paged_prefill_call(a)
            self._install_paged(admitted, a, logits, new, wave_t0=t0, t_admit=t0)
            free = [i for i, r in enumerate(self.slots) if r is None]

    def _paged_arrays(self, admitted) -> dict:
        """Host-side arrays for one paged group's suffix prefill."""
        bs = self.block_size
        blen = bucket_len(max(len(r.prompt) - len(c) * bs for r, c, _ in admitted),
                          self.buckets)
        gp = pad_group(len(admitted))
        toks = np.zeros((gp, blen), np.int32)
        lens = np.ones((gp,), np.int32)
        plens = np.zeros((gp,), np.int32)
        ctx_lens = np.zeros((gp,), np.int32)
        rows = np.tile(self._hole_row, (gp, 1))          # (gp, n_pages)
        dest = np.tile(self._hole_row, (gp, 1))
        max_ctx_pages = max(len(c) for _, c, _ in admitted)
        for j, (r, chain, blocks) in enumerate(admitted):
            ctx_pages = len(chain)
            suffix = r.prompt[ctx_pages * bs:]
            toks[j, :len(suffix)] = suffix
            lens[j] = len(suffix)
            plens[j] = len(r.prompt)
            ctx_lens[j] = ctx_pages * bs
            rows[j, :ctx_pages] = [n.block for n in chain]
            rows[j, ctx_pages:ctx_pages + len(blocks)] = blocks
            # the suffix cache's page i lands in the slot's page ctx_pages + i
            dest[j, :self.n_pages - ctx_pages] = rows[j, ctx_pages:]
        ctx_tab = np.zeros((gp, max_ctx_pages), np.int32)   # short rows repeat block 0
        for j, (_, chain, _) in enumerate(admitted):
            ctx_tab[j, :len(chain)] = [n.block for n in chain]
        return {"toks": toks, "lens": lens, "plens": plens, "ctx_lens": ctx_lens,
                "rows": rows, "dest": dest, "blen": blen, "gp": gp,
                "max_ctx_pages": max_ctx_pages, "ctx_tab": ctx_tab}

    def _paged_prefill_call(self, a: dict):
        """One blocking suffix prefill: plain (or chunked), or against the
        gathered cached prefix."""
        if a["max_ctx_pages"] == 0:
            return self._prefill(a["toks"], a["lens"])
        ctx = kvc.gather_prefix_context(self.caches, self._tensor(a["ctx_tab"]),
                                        self._codec, self.api.cfg.kv_head_dim())
        return self.api.prefill_ctx(self.params, {"tokens": self._tensor(a["toks"])}, ctx,
                                    self._tensor(a["ctx_lens"]), max_len=self.pool_len,
                                    seq_lens=self._tensor(a["lens"]))

    def _install_paged(self, admitted, a: dict, logits, new, *, wave_t0=None, t_admit=0.0):
        """Scatter one prefilled paged group into its blocks and free slots,
        in place, then publish its prompts' full blocks: shared by the
        blocking wave and the interleaved job (``wave_t0``, ``t_admit`` as
        in _install_contig)."""
        bs = self.block_size
        free = [i for i, r in enumerate(self.slots) if r is None]
        slots = free[:len(admitted)]
        nxt = self._sample(logits, [r for r, _, _ in admitted]
                           + [None] * (a["gp"] - len(admitted)))
        self.caches = kvc.paged_insert_prefill(self.caches, new, self._tensor(a["dest"]))
        # dummy rows aim past the pool and drop
        slot_idx = np.full((a["gp"],), self.max_batch, np.int64)
        slot_idx[:len(slots)] = slots
        self.caches = kvc.paged_update_slots(self.caches, self._tensor(a["rows"]),
                                             self._tensor(a["plens"]),
                                             self._tensor(slot_idx))
        self.stats["prefills"] += 1
        now = 0.0
        if self.tm is not None:
            now = self.tm.clock()
            if wave_t0 is not None:
                self.tm.prefill_wave(wave_t0, n_reqs=len(admitted), bucket=a["blen"], now=now)
        for j, (r, chain, blocks) in enumerate(admitted):
            slot = slots[j]
            self.slots[slot] = r
            st = _PagedSlot(plen=len(r.prompt), row=a["rows"][j], chain=chain,
                            private=list(blocks))
            self._pstate[slot] = st
            self.stats["admitted"] += 1
            self.stats["prefilled_tokens"] += int(a["lens"][j])
            self.stats["cached_prompt_tokens"] += int(a["ctx_lens"][j])
            if self.tm is not None:
                self.tm.request_admitted(r.rid, slot=slot, prefilled_tokens=int(a["lens"][j]),
                                         cached_tokens=int(a["ctx_lens"][j]), now=t_admit)
                self.tm.tokens_emitted(r.rid, 1, now=now)
            self.pool.record_hit(chain)
            if self.prefix_on:
                # publish the prompt's full blocks past the matched prefix:
                # requests of later waves share them (a wave's requests
                # prefill independently)
                for pi in range(len(chain), len(r.prompt) // bs):
                    self._publish_block(st, pi, r)
            self._append_token(slot, int(nxt[j]))

    def _publish_block(self, st: _PagedSlot, pi: int, r: Request):
        """Hang slot page pi (now full and immutable) on the radix tree."""
        bs = self.block_size
        seq = r.prompt if (pi + 1) * bs <= st.plen \
            else np.concatenate([r.prompt, np.asarray(r.out, np.int32)])
        parent = st.chain[-1] if st.chain else None
        node, owned = self.pool.publish(parent, seq[pi * bs:(pi + 1) * bs], int(st.row[pi]),
                                        clock=self.step_count)
        if owned:
            st.private.remove(int(st.row[pi]))
        st.chain.append(node)

    # -- interleaved prefill (slices beside the decode ticks) -----------------

    def _start_jobs(self):
        """Dequeue admissible work into new prefill jobs. Slots are committed
        (deducted from capacity) here, so two jobs never target the same
        future vacancy, but assigned only at install."""
        free = sum(1 for r in self.slots if r is None) - self._committed
        while free > 0 and self.queue:
            if self.paged:
                admitted = self._select_paged(free)
                if not admitted:
                    break
                a = self._paged_arrays(admitted)
                # a cached-prefix group cannot slice (its attention reads
                # gathered context): one blocking call at its turn
                job = _PrefillJob(admitted=admitted, toks=a["toks"], lens=a["lens"],
                                  blen=a["blen"], gp=a["gp"],
                                  monolithic=a["max_ctx_pages"] > 0, arrays=a)
            else:
                group = self.sched.select(self.queue, free, clock=self.step_count)
                if not group:
                    break
                for r in group:
                    self.queue.remove(r)
                toks, lens, blen, gp = self._group_arrays(group)
                job = _PrefillJob(admitted=[(r, [], []) for r in group], toks=toks,
                                  lens=lens, blen=blen, gp=gp, monolithic=False,
                                  arrays=None)
            if not job.monolithic:
                # copied to the device here, once: a slice copies nothing
                # from the host (and so never waits for the device)
                job.toks_dev, job.lens_dev = self._tensor(job.toks), self._tensor(job.lens)
            reqs = [r for r, _, _ in job.admitted]
            c = min(self.slice_chunk, job.blen)
            job.todo = -(-int(job.lens.max()) // c) * c
            job.rank = min(slo_rank(r.slo) for r in reqs)
            job.arrival = min(r.arrival for r in reqs)
            job.t_start = self.tm.clock() if self.tm is not None else 0.0
            self._jobs.append(job)
            self._committed += len(reqs)
            self.stats["prefill_jobs"] += 1
            free = sum(1 for r in self.slots if r is None) - self._committed

    def _job_key(self, job: _PrefillJob):
        """Job service order: starved first, then (SLO rank, arrival)."""
        limit = getattr(self.sched, "starvation_limit", None)
        starved = limit is not None and self.step_count - job.arrival > limit
        return (0 if starved else 1, job.rank, job.arrival)

    def _advance_job(self, job: _PrefillJob) -> bool:
        """One unit of prefill work; True: the job finished and installed."""
        if job.monolithic:
            logits, new = self._paged_prefill_call(job.arrays)
            self._install_paged(job.admitted, job.arrays, logits, new, t_admit=job.t_start)
            return True
        t0 = self.tm.clock() if self.tm is not None else 0.0
        if job.caches is None:
            # the job's transient cache: zeros on the pool's device
            job.caches, job.h_last = self.api.prefill_slice_init(job.gp, self.pool_len,
                                                                 device=self.device)
        c = min(self.slice_chunk, job.blen)
        job.h_last, job.caches = self.api.prefill_slice(
            self.params, job.caches, job.toks_dev[:, job.pos:job.pos + c], job.h_last,
            job.lens_dev, job.pos)
        job.pos += c
        self.stats["prefill_slices"] += 1
        if self.tm is not None:
            self.tm.prefill_slice(t0, n_reqs=len(job.admitted), tokens=c * job.gp,
                                  bucket=job.blen)
        if job.pos < job.todo:
            return False
        logits, new = self.api.prefill_slice_finish(self.params, job.caches, job.h_last,
                                                    job.lens_dev)
        job.caches = job.h_last = None
        if self.paged:
            self._install_paged(job.admitted, job.arrays, logits, new, t_admit=job.t_start)
        else:
            self._install_contig([r for r, _, _ in job.admitted], job.blen, job.gp, logits,
                                 new, t_admit=job.t_start)
        return True

    def _prefill_tick(self):
        """Interleave-mode admission: start jobs for queued work, then run up
        to ``slices_per_tick`` units of prefill beside this tick's decode
        batch. With no slot decoding there is nothing to starve, so the
        backlog drains freely until an install re-arms the decode loop."""
        self._start_jobs()
        idle = all(r is None for r in self.slots)
        n = self.slices_per_tick
        while self._jobs and (n > 0 or idle):
            job = min(self._jobs, key=self._job_key)
            n -= 1
            if self._advance_job(job):
                self._jobs.remove(job)
                self._committed -= len(job.admitted)
                # an install can finish at once (max_new = 1) and free its
                # slots again: let newly admissible work start now
                self._start_jobs()
                idle = all(r is None for r in self.slots)

    def _admit_tick(self) -> bool:
        """A tick's admission (blocking waves, or interleaved jobs); True if
        a slot is left to decode. With jobs still in flight and no slot
        decoding, the clock moves on and the tick reports busy."""
        if self.interleave:
            self._prefill_tick()
        else:
            self._admit()
        return any(r is not None for r in self.slots)

    # -- engine ticks -------------------------------------------------------

    def step(self) -> bool:
        """One tick: admit into free slots, then one batched decode step over
        the full pool (or one draft / verify wave with spec_k > 0). Returns
        False once no slot is occupied and no prefill job is in flight."""
        if self.spec_k:
            return self._step_spec()
        if not self._admit_tick():
            return self._idle_tick()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        t0 = self.tm.clock() if self.tm is not None else 0.0
        self._fill(tok=self.next_tok)
        if self.temperature > 0:
            rids, steps = self._stream_arrays(self.slots)
            self._fill(rids=rids, steps=steps)
        (picked,) = self._step_fn()
        nxt = picked.cpu().numpy()
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["occupied_slot_steps"] += len(active)
        now = 0.0
        if self.tm is not None:
            now = self.tm.clock()
            self.tm.decode_tick(t0, n_active=len(active), now=now)
        for i in active:
            r = self.slots[i]
            if self.prefix_on:
                # the decode wrote K/V at position plen + len(out) - 1: publish
                # the block it completed, if any
                st = self._pstate[i]
                cur = st.plen + len(r.out)       # cache length after this tick
                if cur % self.block_size == 0:
                    self._publish_block(st, cur // self.block_size - 1, r)
            if self.tm is not None:
                self.tm.tokens_emitted(r.rid, 1, now=now)
            self._append_token(i, int(nxt[i]))
        if self.tm is not None:
            self.tm.update_gauges(self._telemetry_gauges())
        return True

    def _idle_tick(self) -> bool:
        """No slot to decode: busy (the clock moves on) while prefill jobs
        are in flight, idle otherwise."""
        if self._jobs:
            self.step_count += 1
            return True
        return False

    def _step_spec(self) -> bool:
        """One speculative wave: admit, draft spec_k tokens through the
        binarized self-draft (sharing the target's cache), verify them and
        the pending token in one float pass, and keep each slot's longest
        matching prefix plus one correction / bonus token. The wave's j-th
        token is drawn from the target's logits on the request's own (rid,
        step) stream, so the tokens equal the plain engine's; the draft only
        decides how many a wave banks (1 .. spec_k + 1 a slot)."""
        if not self._admit_tick():
            return self._idle_tick()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        k = self.spec_k
        # the pre-wave cache length per slot (plen + len(out) - 1: next_tok's
        # K/V is not in yet); free slots pin to 0, so their scratch writes
        # stay invisible and bounded, and to stream (0, 0)
        base_len = np.zeros((self.max_batch,), np.int32)
        for i in active:
            r = self.slots[i]
            base_len[i] = len(r.prompt) + len(r.out) - 1
        t0 = self.tm.clock() if self.tm is not None else 0.0
        rids, steps = self._stream_arrays(self.slots)
        self._fill(tok=self.next_tok, rids=rids, steps=steps, base_lens=base_len)
        toks, cand = self._step_fn()
        tok_mat, cand = toks.cpu().numpy(), cand.cpu().numpy()      # (B, k + 1)
        self.stats["spec_draft_launches"] += 1

        # accept / reject on the host, then roll the lengths back before any
        # bookkeeping: rejected positions fall past len (free slots to 0);
        # a paged _finish, which zeroes its slot, runs after this
        wave: dict[int, list[int]] = {}
        new_lens = np.zeros((self.max_batch,), np.int32)
        for i in active:
            emitted = accept_wave(cand[i], tok_mat[i, 1:])
            wave[i] = emitted
            self.stats["spec_drafted"] += k
            self.stats["spec_accepted"] += len(emitted) - 1
            new_lens[i] = base_len[i] + len(emitted)
        kvc.set_cache_lengths(self.caches, self._tensor(new_lens))
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["spec_waves"] += 1
        self.stats["occupied_slot_steps"] += len(active)
        now = 0.0
        if self.tm is not None:
            now = self.tm.clock()
            self.tm.spec_wave(t0, n_active=len(active), k=k,
                              accepted=sum(len(w) - 1 for w in wave.values()), now=now)
        for i in active:
            r = self.slots[i]
            if self.tm is not None:
                # the tokens this wave emits: the accept rule's, cut at
                # max_new or the first stop token, as the loop below cuts
                n_emit, room = 0, r.max_new - len(r.out)
                for tok in wave[i]:
                    n_emit += 1
                    if n_emit >= room or int(tok) in r.stop_tokens:
                        break
                self.tm.tokens_emitted(r.rid, n_emit, now=now)
            for tok in wave[i]:
                if self.prefix_on:
                    # as in the plain tick: the verify completed the block
                    # covering [cur - bs, cur) with exact K/V
                    st = self._pstate[i]
                    cur = st.plen + len(r.out)
                    if cur % self.block_size == 0:
                        self._publish_block(st, cur // self.block_size - 1, r)
                if self._append_token(i, int(tok)):
                    # finished (max_new or a stop token): the rest of the
                    # wave is neither emitted nor counted
                    break
        if self.tm is not None:
            self.tm.update_gauges(self._telemetry_gauges())
        return True

    def _telemetry_gauges(self) -> dict:
        """Instantaneous occupancy and cache-pressure values, all host-side
        (the slot table, the queue, the paged pool's free list, never a
        tensor); every ratio reads 0.0 before the first tick."""
        occ = sum(1 for s in self.slots if s is not None)
        g = {"serve_slots_occupied": occ,
             "serve_queue_depth": len(self.queue),
             "serve_slot_occupancy": occ / self.max_batch if self.max_batch else 0.0}
        if self.interleave:
            g["serve_prefill_jobs"] = len(self._jobs)
        if self.paged:
            free = len(self.pool.free)
            g["kv_blocks_free"] = free
            g["kv_pool_occupancy"] = 1.0 - free / self.n_blocks if self.n_blocks else 0.0
        else:
            g["kv_pool_occupancy"] = g["serve_slot_occupancy"]
        if self.prefix_on:
            hit = self.stats["cached_prompt_tokens"]
            tot = hit + self.stats["prefilled_tokens"]
            g["serve_prefix_hit_rate"] = hit / tot if tot else 0.0
        if self.spec_k:
            g["serve_spec_acceptance"] = self.acceptance_rate()
        return g

    def acceptance_rate(self) -> float:
        """Fraction of draft tokens the verify pass accepted."""
        d = self.stats["spec_drafted"]
        return self.stats["spec_accepted"] / d if d else 0.0

    def run(self) -> dict[int, list[int]]:
        """Drain queue and slots; returns rid -> generated ids (cumulative
        over the engine's lifetime, so arrivals between run() calls work)."""
        while self.step():
            pass
        return dict(self.results)

    def utilization(self) -> float:
        """Mean fraction of occupied slots per decode step."""
        steps = self.stats["decode_steps"]
        if steps == 0:
            return 0.0
        return self.stats["occupied_slot_steps"] / (steps * self.max_batch)
