"""RWKV6-3B (Finch) [arXiv:2404.05892]: attention-free, data-dependent decay
time-mix + squared-relu channel-mix."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # wkv heads of dim 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
