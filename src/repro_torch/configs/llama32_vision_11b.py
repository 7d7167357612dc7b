"""Llama-3.2-11B-Vision [hf:meta-llama; unverified tier]: decoder with gated
cross-attention layers; vision frontend stubbed (precomputed patch embeds)."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    rope_base=500_000.0,
    cross_every=5,       # a gated cross-attn block after every 5 self blocks
    n_patches=1601,
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, cross_every=2, n_patches=16, attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
