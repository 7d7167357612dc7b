"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA (kv_lora=512), MoE 160e top-6,
2 shared experts. Binary experts are the paper-technique sweet spot."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    vocab=102400,
    d_ff=12288,           # dense-FFN layers (first_dense_layers)
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    router_type="softmax",
    fsdp=True,
    opt_moment_dtype="bfloat16",
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=2,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16, n_experts=8, n_shared_experts=1,
        top_k=2, moe_d_ff=32, first_dense_layers=1, fsdp=False,
        attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
