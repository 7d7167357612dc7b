"""Continuous-batching slot engine (port of repro/serving/engine.py: the
slot-contiguous bf16 pool, greedy decoding, the FIFO scheduler).

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
as ``jnp.argmax`` does. The pool lives on the device of ``params`` and is
updated in place.

Not ported yet, and refused with the ROADMAP item that ports them: sampled
decoding (temperature > 0) and speculative decoding (A5), the quantized KV
codecs (A3), the paged pool and prefix cache (A4), interleaved prefill,
the SLO scheduler and telemetry (A6), and meshes (A9).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.kvcache import kv_pool_bytes
from repro_torch.serving.scheduler import (AdmissionError, FifoScheduler, Request,
                                           bucket_len, make_buckets, pad_group,
                                           slo_rank)

# every ServeEngine.stats key and what it counts
STATS_SCHEMA = {
    "decode_steps": "engine ticks (batched decode steps)",
    "occupied_slot_steps": "sum over ticks of occupied slots",
    "prefills": "prefill waves (one per admitted group)",
    "admitted": "requests admitted into a slot",
    "evictions": "requests finished and evicted",
    "generated_tokens": "tokens emitted across all requests",
    "prefilled_tokens": "prompt tokens run through prefill",
    "kv_bytes": "resident bytes of the preallocated KV pool",
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ServeEngine:
    def __init__(self, api, params, *, max_batch: int = 8, max_len: int = 512,
                 temperature: float = 0.0, attn_impl: str | None = None,
                 kv_block_size: int = 0, prefix_cache: bool = False,
                 spec_k: int = 0, mesh=None,
                 telemetry=None, interleave: bool = False,
                 scheduler: str = "fifo"):
        if temperature > 0:
            _not_ported("sampled decoding (temperature > 0)", "A5")
        if spec_k:
            _not_ported("speculative decoding (spec_k)", "A5")
        if kv_block_size or prefix_cache:
            _not_ported("the paged pool and prefix cache", "A4")
        if interleave:
            _not_ported("interleaved prefill", "A6")
        if telemetry is not None:
            _not_ported("serving telemetry", "A6")
        if scheduler == "slo":
            _not_ported("the SLO scheduler", "A6")
        if scheduler != "fifo":
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if mesh is not None:
            _not_ported("tensor-parallel serving (mesh)", "A9")
        if attn_impl is not None:
            # model fns close over cfg, so a fresh api is the only seam
            from repro_torch.models import get_model
            api = get_model(api.cfg.replace(attn_impl=attn_impl))
        self.api, self.params = api, params
        self.device = params["embed"]["table"].device
        self.max_batch, self.max_len = max_batch, max_len
        self._next_rid = 0
        self.queue: list[Request] = []
        self.results: dict[int, list[int]] = {}
        self.buckets = make_buckets(max_len)
        self.sched = FifoScheduler(self.buckets)
        self.slots: list[Request | None] = [None] * max_batch
        self.next_tok = np.zeros((max_batch, 1), np.int32)
        self.caches = api.init_cache(max_batch, max_len, self.device)
        self.step_count = 0
        self.stats = {k: 0 for k in STATS_SCHEMA}
        self.stats["kv_bytes"] = kv_pool_bytes(self.caches)

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
        if prompt_len + max_new > self.max_len:
            raise AdmissionError(
                "too_long",
                f"prompt ({prompt_len}) + max_new ({max_new}) exceeds max_len "
                f"({self.max_len})",
                prompt_len=int(prompt_len), max_new=int(max_new),
                spec_k=0, max_len=int(self.max_len))

    def add_request(self, prompt, max_new: int = 16, stop_tokens=(),
                    slo: str = "standard") -> int:
        prompt = np.asarray(prompt, np.int32)
        self.check_request(len(prompt), max_new, slo)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new,
                                  stop_tokens=frozenset(int(t) for t in stop_tokens),
                                  slo=slo, arrival=self.step_count))
        return rid

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy: the first maximum of each row."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # -- slot lifecycle -----------------------------------------------------

    def _finish(self, slot: int):
        r = self.slots[slot]
        self.results[r.rid] = r.out
        self.slots[slot] = None
        self.stats["evictions"] += 1

    def _append_token(self, slot: int, tok: int) -> bool:
        """Record one generated token; True if the request ended (max_new or
        stop token) and its slot was freed."""
        r = self.slots[slot]
        r.out.append(tok)
        self.next_tok[slot, 0] = tok
        self.stats["generated_tokens"] += 1
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

    def _install_contig(self, group, gp, logits, new):
        """Sample first tokens and scatter one prefilled group's caches into
        free slots."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        nxt = self._sample(logits)
        # dummy rows aim past the pool and are dropped by the scatter
        idx = np.full((gp,), self.max_batch, np.int64)
        idx[:len(group)] = free[:len(group)]
        self.caches = self.api.cache_insert(
            self.caches, new, torch.as_tensor(idx, device=self.device))
        self.stats["prefills"] += 1
        for j, r in enumerate(group):
            slot = int(idx[j])
            self.slots[slot] = r
            self.stats["admitted"] += 1
            self.stats["prefilled_tokens"] += len(r.prompt)
            self._append_token(slot, int(nxt[j]))

    def _admit(self):
        """Prefill queued requests into free slots (one group per bucket)."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.queue:
            group = self.sched.select(self.queue, len(free))
            if not group:
                break
            for r in group:
                self.queue.remove(r)
            toks, lens, blen, gp = self._group_arrays(group)
            logits, new = self.api.prefill(
                self.params, {"tokens": torch.as_tensor(toks, device=self.device)},
                max_len=self.max_len,
                seq_lens=torch.as_tensor(lens, device=self.device))
            self._install_contig(group, gp, logits, new)
            free = [i for i, r in enumerate(self.slots) if r is None]

    # -- engine ticks -------------------------------------------------------

    def step(self) -> bool:
        """One tick: admit into free slots, then one batched decode step over
        the full pool. Returns False once no slot is occupied (idle)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        logits, self.caches = self.api.decode(
            self.params, self.caches, torch.as_tensor(self.next_tok, device=self.device))
        nxt = self._sample(logits)
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["occupied_slot_steps"] += len(active)
        for i in active:
            self._append_token(i, int(nxt[i]))
        return True

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
