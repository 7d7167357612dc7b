"""The paper's exact network: fully-connected 784-1024-1024-1024-10 on
MNIST, BatchNorm + hardtanh after each hidden layer (paper section 3A).
Port of repro/core/hybrid_mlp.py.

Two variants share this code:
  * float  — all four weight matrices float (f32 here, as in repro; Table II
             counts them at bf16's 2 bytes)
  * hybrid — the two 1024x1024 hidden matrices binarized (BEANNA column)

Memory accounting reproduces the paper's Table II to the byte:
  float : 2,910,208 params x 2 B             = 5,820,416 B
  hybrid: (784*1024 + 1024*10) x 2 B
          + 2 x 1024*1024 / 8 B              = 1,888,256 B

The binary layers run the XNOR-popcount kernel (B1) on the card by default
(``mode="xnor"``): in every training and eval forward, on the current latent,
and in packed inference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import hardtanh
from repro_torch.core.binary_dense import (binary_dense_apply, binary_dense_apply_packed,
                                           binary_dense_bytes, binary_dense_init,
                                           pack_for_inference)
from repro_torch.device import resolve_device
from repro_torch.nn import layers as nn

DIMS = (784, 1024, 1024, 1024, 10)
BINARY_LAYERS = (1, 2)  # the two 1024x1024 hidden matrices


def mlp_init(seed: int, *, hybrid: bool, dims=DIMS, device="cuda") -> dict:
    """Random init from ``seed`` on ``device`` (the card unless asked for the
    CPU), with repro's distributions (not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {}
    for i in range(len(dims) - 1):
        if hybrid and i in BINARY_LAYERS:
            params[f"fc{i}"] = {"bin": binary_dense_init(
                dims[i], dims[i + 1], generator=gen, device=device, scale=False)}
        else:
            params[f"fc{i}"] = nn.dense_init(dims[i], dims[i + 1], generator=gen,
                                             device=device, bias=True,
                                             dtype=torch.float32)
        if i < len(dims) - 2:  # BN on hidden layers
            params[f"bn{i}"] = nn.batchnorm_init(dims[i + 1], device=device)
    return params


def mlp_apply(params: dict, x: torch.Tensor, *, training: bool, mode: str = "xnor"):
    """x (B, 784) in [-1, 1]. Returns (logits, new params with BN stats)."""
    new = dict(params)
    n_layers = len(DIMS) - 1
    h = x.to(torch.float32)
    for i in range(n_layers):
        p = params[f"fc{i}"]
        if "bin" in p:
            h = binary_dense_apply(p["bin"], h, mode=mode)
        else:
            h = nn.dense_apply(p, h, compute_dtype=torch.float32)
        if i < n_layers - 1:
            h, new[f"bn{i}"] = nn.batchnorm_apply(params[f"bn{i}"], h, training=training)
            h = hardtanh(h)
    return h, new


def mlp_pack(params: dict) -> dict:
    """Deploy-time packing: drop latents for 1-bit packed weights."""
    return {k: {"bin_packed": pack_for_inference(v["bin"])}
            if isinstance(v, dict) and "bin" in v else v
            for k, v in params.items()}


def mlp_apply_packed(params: dict, x: torch.Tensor, *, mode: str = "xnor") -> torch.Tensor:
    """Inference with packed weights (weights never unpacked to float)."""
    n_layers = len(DIMS) - 1
    h = x.to(torch.float32)
    for i in range(n_layers):
        p = params[f"fc{i}"]
        if "bin_packed" in p:
            h = binary_dense_apply_packed(p["bin_packed"], h, mode=mode)
        else:
            h = nn.dense_apply(p, h, compute_dtype=torch.float32)
        if i < n_layers - 1:
            h, _ = nn.batchnorm_apply(params[f"bn{i}"], h, training=False)
            h = hardtanh(h)
    return h


def mlp_loss(params: dict, batch, *, training: bool = True, mode: str = "xnor"):
    """Mean cross-entropy; returns (loss, (new params, logits))."""
    x, y = batch
    logits, new = mlp_apply(params, x, training=training, mode=mode)
    logits = logits.to(torch.float32)
    ll = F.log_softmax(logits, dim=-1)
    loss = -ll.gather(1, y.long()[:, None]).mean()
    return loss, (new, logits)


@torch.no_grad()
def mlp_accuracy(params: dict, x: torch.Tensor, y: torch.Tensor, *,
                 mode: str = "xnor") -> torch.Tensor:
    logits, _ = mlp_apply(params, x, training=False, mode=mode)
    return (logits.argmax(-1) == y).float().mean()


def weight_memory_bytes(*, hybrid: bool, dims=DIMS) -> int:
    """Deployed off-chip weight memory (paper Table II accounting: weights
    only, bf16 = 2 B or packed 1-bit)."""
    total = 0
    for i in range(len(dims) - 1):
        if hybrid and i in BINARY_LAYERS:
            total += binary_dense_bytes(dims[i], dims[i + 1])
        else:
            total += dims[i] * dims[i + 1] * 2
    return total
