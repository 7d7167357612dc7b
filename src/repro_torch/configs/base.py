"""Config system (a copy of repro/configs/base.py, so that this package
imports nothing from repro): one dataclass covers the whole model zoo;
per-arch files instantiate it with the exact published hyperparameters.

PrecisionPolicy is the paper's contribution surfaced as a first-class config:
which layers are binarized (hidden blocks), which stay float (edge layers,
routers, recurrent state paths), and which TPU lowering the binary layers use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class PrecisionPolicy:
    """Hybrid binary/float schedule (BEANNA's hybrid network, generalized)."""
    binary_ffn: bool = False          # binarize FFN/channel-mix of hidden blocks
    edge_blocks_float: int = 1        # first/last N blocks stay float (paper rule)
    binary_mode: str = "int8"         # "xnor" | "int8" | "bf16" lowering
    binary_attn_proj: bool = False    # also binarize attention out-projections

    def block_is_binary(self, idx: int, n_layers: int) -> bool:
        if not self.binary_ffn:
            return False
        e = self.edge_blocks_float
        return e <= idx < n_layers - e


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense|moe|mamba2_hybrid|rwkv6|whisper|vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_base: float = 10000.0
    use_rope: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MLA ---
    use_mla: bool = False
    q_lora_rank: int = 0              # 0 = no q compression
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0                 # per-expert hidden
    first_dense_layers: int = 1       # leading dense FFN layers (deepseek)
    router_type: str = "softmax"      # softmax (v2) | sigmoid (v3)
    capacity_factor: float = 1.25
    use_mtp: bool = False             # multi-token prediction head (v3)

    # --- SSM / hybrid ---
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 6               # zamba2: shared attn block period

    # --- whisper ---
    enc_layers: int = 0
    n_audio_frames: int = 1500

    # --- vlm ---
    cross_every: int = 0              # insert cross-attn after every N self blocks
    n_patches: int = 1601

    # --- precision / dtypes ---
    policy: PrecisionPolicy = field(default_factory=PrecisionPolicy)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"  # bf16 halves optimizer memory at 70B+

    # --- training / distribution ---
    remat: str = "block"              # none | block | full
    fsdp: bool = False
    scan_layers: bool = True
    attn_chunk: int = 1024
    # attention backend: auto | ref | flash (the port's names; resolved per
    # call by nn/attention.resolve_attn_impl)
    attn_impl: str = "auto"
    cache_update: str = "auto"        # auto | dus | mask (see attention.py;
    #                                   auto -> mask under a sharded mesh)
    # KV-cache storage codec for GQA K/V pools: auto | bf16 | int8 | binary
    # (auto = bf16; resolved by nn/attention.resolve_kv_cache and
    # implemented in serving/kvcache.py. MLA's compressed cache is already
    # the memory optimization for that family and stays bf16.)
    kv_cache: str = "auto"
    # Packed-weight lowering for the binarized self-draft of speculative
    # decoding: auto | xla_xnor | int8_mxu | pallas_xnor (kernels/ops.py
    # SPEC_DRAFT_IMPLS). auto keeps resolve_impl's backend default (XLA
    # XNOR twin on CPU, Pallas popcount kernel on TPU); int8_mxu lowers
    # sign bits to +-1 int8 dot_general — the MXU path. All lowerings are
    # exact-int32 twins, so the knob is pure wall-clock, never tokens.
    spec_draft_impl: str = "auto"
    shard_kv_heads: bool = True       # False: replicate wk/wv over model
    serve_cache_sharding: str = "explicit"  # explicit | auto (GSPMD picks)
    serve_mesh: str = ""              # e.g. "32x8": recarve pod for serving
    serve_fsdp: bool = True           # False: no ZeRO-gather at inference
    serve_shard_cache_seq: bool = False  # seq-parallel decode attention
    pp_stages: int = 1                # documented >4k-chip path; 1 = no PP

    def kv_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def sub_quadratic(self) -> bool:
        return self.family in ("mamba2_hybrid", "rwkv6")

    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
