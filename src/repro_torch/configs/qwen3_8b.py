"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense decoder, GQA kv=8, qk-norm."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_base=1_000_000.0,
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
