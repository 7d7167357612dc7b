"""The paper's own network: fully-connected 784-1024-1024-1024-10 on MNIST,
hardtanh + batchnorm after each layer; hybrid = binary hidden layers."""

from repro_torch.configs.base import ModelConfig, PrecisionPolicy

# Encoded in ModelConfig loosely; core/hybrid_mlp.py reads these fields.
CONFIG = ModelConfig(
    name="beanna-mnist",
    family="mlp",
    n_layers=4,            # 4 weight matrices: 784-1024-1024-1024-10
    d_model=1024,
    d_ff=784,              # input dim
    vocab=10,              # classes
    policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                           binary_mode="xnor"),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(d_model=128)
