"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + a shared attention
block invoked every `attn_every` mamba blocks (weights shared)."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="mamba2_hybrid",
    n_layers=54,          # mamba2 blocks
    d_model=2560,
    n_heads=32,           # shared attention block heads
    n_kv_heads=32,
    d_ff=10240,           # shared block MLP hidden
    vocab=32000,
    d_state=64,
    d_conv=4,
    expand=2,
    attn_every=6,
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, d_state=16, attn_every=2, ssm_chunk=32, attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
