"""Run-to-completion bucket engine, the serving baseline (port of
repro/serving/bucket.py).

Requests are grouped by *exact* prompt length; each group is prefilled and
decoded to completion before the next group is admitted. Slots that finish
early idle until the whole group drains, and no new work joins mid-decode:
the cost the continuous-batching slot engine (serving/engine.py) removes.

On a card a group's prefill runs the flash kernel (B3) and every decode
step the int8-binary GEMM (B2) in the binary FFNs, as the slot engine's
blocking waves and ticks do, eagerly (no graphs: the group's shape changes
with every wave). Sampling (``temperature > 0``) splits one key per step
from PRNGKey(seed) and draws the whole group's rows from it, with JAX's
bits (serving/sampling.py), so the tokens equal repro's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving import sampling


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class BucketEngine:
    def __init__(self, api, params, *, max_batch: int = 8, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0, attn_impl: str | None = None,
                 kv_cache: str | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving (mesh) is not ported yet "
                                      "(ROADMAP A9)")
        overrides = {k: v for k, v in (("attn_impl", attn_impl), ("kv_cache", kv_cache))
                     if v is not None}
        if overrides:
            from repro_torch.models import get_model
            api = get_model(api.cfg.replace(**overrides))
        self.api, self.params = api, params
        self.device = params["embed"]["table"].device
        self.max_batch, self.max_len = max_batch, max_len
        self.temperature = float(temperature)
        self.rng = sampling.prng_key(seed, device=self.device)
        self._next_rid = 0
        self.queue: list[Request] = []
        self.results: dict[int, list[int]] = {}

    def add_request(self, prompt, max_new: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                             f"max_len ({self.max_len})")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new))
        return rid

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(G, Vp) -> (G,) int32 on the device: the first maximum, or a draw
        of every row from this step's key (split off the engine's key)."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        self.rng, k = sampling.split(self.rng)
        return sampling.categorical_shared(k, logits / self.temperature).to(torch.int32)

    def run(self) -> dict[int, list[int]]:
        """Process the queue to completion; returns rid -> generated ids
        (cumulative over the engine's lifetime, as ServeEngine.run)."""
        results = self.results
        while self.queue:
            # bucket by prompt length, take up to max_batch
            self.queue.sort(key=lambda r: len(r.prompt))
            plen = len(self.queue[0].prompt)
            group = [r for r in self.queue if len(r.prompt) == plen][:self.max_batch]
            for r in group:
                self.queue.remove(r)
            toks = torch.as_tensor(np.stack([r.prompt for r in group]), device=self.device)
            logits, caches = self.api.prefill(self.params, {"tokens": toks},
                                              max_len=self.max_len)
            nxt = self._sample(logits)
            host = nxt.cpu().numpy()
            for i, r in enumerate(group):
                r.out.append(int(host[i]))
            steps = max(r.max_new for r in group) - 1
            for _ in range(max(steps, 0)):
                logits, caches = self.api.decode(self.params, caches, nxt[:, None])
                nxt = self._sample(logits)
                host = nxt.cpu().numpy()
                for i, r in enumerate(group):
                    if not r.done:
                        r.out.append(int(host[i]))
                        if len(r.out) >= r.max_new:
                            r.done = True
                if all(r.done for r in group):
                    break
            for r in group:
                results[r.rid] = r.out
        return dict(results)
