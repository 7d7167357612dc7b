"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense decoder with MLA."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
