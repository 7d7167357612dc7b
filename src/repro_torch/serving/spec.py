"""Binarized self-draft for speculative decoding (port of
repro/serving/spec.py): BEANNA's float / binary mode switch applied to the
serving loop.

A cheap draft proposes k tokens and one float verify pass keeps the prefix
the target agrees with. The draft is the served model with its float FFN
weights sign-packed, 32 to a word, beside a per-output mean |W|, applied
XNOR-net style as

    x @ W  ~=  (sign(x) @ sign(W)) * beta * alpha

(beta the per-token mean |x|, computed in ``nn/layers.dense_apply``; alpha
baked into the draft params). The packed product is B1, the paper's
XNOR-popcount kernel (``spec_draft_impl`` "auto"), or B2's +-1 int8 product
("int8_mxu"); for a CPU tensor their plain versions. Everything else
(embeddings, norms, attention, the head) is the target's tensors, aliased,
not copied, and FFNs already binary under the precision policy are their
own draft: the only new memory is the packed bits. The draft shares the
target's KV cache: its steps append approximate K/V past the valid
length, the verify overwrites them with exact K/V before any becomes
visible, and the rollback is a per-slot length reset.

``make_draft_wave`` and ``make_spec_wave`` build a whole wave as one
function over tensors: k draft decodes with the token picks on the device
(no host round trip between steps), the rewind, the verify and the
candidate picks. The engine runs it as one CUDA graph replay on the card
(serving/graphs.py), the counterpart of repro's one jitted launch.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import pack_bits
from repro_torch.serving import sampling
from repro_torch.serving.kvcache import set_cache_lengths


def _pack_dense(p: dict) -> dict:
    """One float dense {"w": (K, N)} -> the draft's {"w_packed": (N,
    ceil(K / 32)) int32 sign words, "scale": (N,) f32 mean |W| per output}
    (a bias passes through): the layout binary_dense_apply_packed reads."""
    wt = p["w"].to(torch.float32).T                        # (N, K)
    out = {"w_packed": pack_bits(wt), "scale": wt.abs().mean(dim=-1)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def binarize_draft_params(params: dict, cfg=None) -> dict:
    """Target LM params -> the binary self-draft's params.

    Every float SwiGLU FFN (w_gate / w_up / w_down) becomes its packed,
    scaled form. Embeddings, norms, attention and the head stay float (the
    paper's edge-layers rule), and FFNs that are already binary ("bin_in"
    blocks) are kept as they are: each of those dicts is the target's own
    object. (repro's ``attn_proj``, which also packs QKV / O, is off in
    every caller and not ported.)"""
    del cfg  # the geometry is in the params
    blocks = []
    for blk in params["blocks"]:
        ffn = blk["ffn"]
        if isinstance(ffn.get("w_gate"), dict) and "w" in ffn["w_gate"]:
            ffn = {k: _pack_dense(v) if k in ("w_gate", "w_up", "w_down") else v
                   for k, v in ffn.items()}
        blocks.append({**blk, "ffn": ffn})
    return {**params, "blocks": blocks}


def make_draft_wave(api, *, k: int, temperature: float = 0.0, seed_key=None):
    """The k draft decodes as one function: ``wave(draft_params, caches,
    first_tok, rids, base_steps) -> (toks (B, k + 1) int32, caches)``, where
    toks[:, 0] is first_tok (B, 1) and toks[:, 1:] the k proposals. Step j
    picks row r's token as the engine does: the first maximum, or a draw
    from fold_in(fold_in(seed, rids[r]), base_steps[r] + j). The picks stay
    on the device, so nothing waits on the host between steps. The caches
    come back with the draft's K/V appended (positions base_len .. base_len
    + k - 1) and no rewind, so the wave equals k sequential ``api.decode``
    calls."""
    def wave(draft_params, caches, first_tok, rids, base_steps):
        toks = [first_tok]
        for j in range(k):
            logits, caches = api.decode(draft_params, caches, toks[-1])
            toks.append(sampling.pick(logits, temperature, seed_key, rids, base_steps + j)[:, None])
        return torch.cat(toks, dim=1), caches

    return wave


def make_spec_wave(api, *, k: int, temperature: float = 0.0, seed_key=None):
    """A whole speculative wave as one function: the draft wave, the rewind
    to ``base_lens``, the float verify of all k + 1 tokens, and the
    candidate picks. ``wave(params, draft_params, caches, first_tok, rids,
    base_steps, base_lens) -> (toks (B, k + 1), cand (B, k + 1), caches)``:
    cand[r, j] is the token the target emits at position j from the
    request's (rid, base_step + j) stream. The caches return with the
    verify's exact K/V and ``len`` advanced by k + 1; the engine rolls them
    back to base + accepted."""
    draft_wave = make_draft_wave(api, k=k, temperature=temperature, seed_key=seed_key)

    def wave(params, draft_params, caches, first_tok, rids, base_steps, base_lens):
        toks, caches = draft_wave(draft_params, caches, first_tok, rids, base_steps)
        # the rewind: the draft's K/V drop out of every masked read before
        # the verify overwrites them
        caches = set_cache_lengths(caches, base_lens)
        logits, caches = api.verify(params, caches, toks)
        steps = base_steps[:, None] + torch.arange(k + 1, device=toks.device)[None, :]
        cand = sampling.pick(logits, temperature, seed_key, rids[:, None].expand_as(steps),
                             steps)
        return toks, cand, caches

    return wave


def draft_param_bytes(params: dict) -> int:
    """Bytes of the draft's own leaves: each packed dense's words and scale
    (a dense with ``w_packed`` and no latent; the binary FFNs' packed copy
    belongs to the target). Everything else is the target's tensors."""
    total, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            if "w_packed" in node and "w_latent" not in node:
                total += sum(node[n].numel() * node[n].element_size()
                             for n in ("w_packed", "scale"))
            else:
                stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
    return total
