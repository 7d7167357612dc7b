"""Whisper-base [arXiv:2212.04356]: encoder-decoder; conv frontend stubbed
(input_specs provides precomputed frame embeddings per the assignment)."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

CONFIG = ModelConfig(
    name="whisper-base",
    family="whisper",
    n_layers=6,          # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    n_audio_frames=1500,
    use_rope=False,  # whisper uses learned/sinusoidal positions
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                           binary_mode="int8"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, n_audio_frames=32, attn_chunk=64,
        policy=PrecisionPolicy(binary_ffn=False))
