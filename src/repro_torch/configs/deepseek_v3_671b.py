"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA, MoE 256e top-8 (sigmoid router,
aux-free bias), 1 shared expert, MTP head."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    vocab=129280,
    d_ff=18432,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_type="sigmoid",
    use_mtp=True,
    fsdp=True,
    opt_moment_dtype="bfloat16",
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=3,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16, n_experts=8, n_shared_experts=1,
        top_k=2, moe_d_ff=32, first_dense_layers=1, fsdp=False,
        attn_chunk=64, use_mtp=True,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                               binary_mode="int8"))
