"""Quickstart: the paper's technique end to end (port of examples/quickstart.py).

Builds the hybrid (binary-hidden-layer) network, trains it for 2 epochs on
the synthetic MNIST set with SGD, packs it for deployment (1 bit per hidden
weight) and runs packed inference. On the card the binary layers run the
XNOR-popcount kernel in every forward.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without ``--device`` it runs on the card, and fails where there is none.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import hybrid_mlp as H
from repro_torch.data.synthetic import SyntheticMnist
from repro_torch.device import resolve_device
from repro_torch.optim.bnn import clip_latent_weights

LR = 0.05
EPOCHS = 2
BATCH = 128
RUNNING_STATS = ("mean", "var")    # BatchNorm leaves set by the forward, not SGD


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _replace(tree: dict, new: dict, prefix=()) -> dict:
    return {k: _replace(v, new, prefix + (k,)) if isinstance(v, dict)
            else new.get(prefix + (k,), v) for k, v in tree.items()}


def loss_and_grads(params: dict, x: torch.Tensor, y: torch.Tensor, *, mode: str = "xnor"):
    """The training loss, its gradients {path: tensor} for every leaf SGD
    updates, and the params with the BN stats of this forward."""
    leaves = {path: t.detach().requires_grad_()
              for path, t in _leaves(params) if path[-1] not in RUNNING_STATS}
    loss, (new, _) = H.mlp_loss(_replace(params, leaves), (x, y), mode=mode)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), new


def train_step(params: dict, x: torch.Tensor, y: torch.Tensor, *, lr: float = LR,
               mode: str = "xnor"):
    """One SGD step, as the reference's: p - lr * g, binary latents clipped
    to [-1, 1] (paper eq. 2), BN running stats taken from the forward.
    Returns (new params, loss)."""
    loss, grads, new = loss_and_grads(params, x, y, mode=mode)
    with torch.no_grad():
        upd = _replace(params, {path: t - lr * grads[path]
                                for path, t in _leaves(params) if path in grads})
    upd = clip_latent_weights(upd)
    for k in new:
        if k.startswith("bn"):
            upd[k] = {**upd[k], "mean": new[k]["mean"], "var": new[k]["var"]}
    return upd, loss


def train(params: dict, data: SyntheticMnist, *, epochs: int = EPOCHS, batch: int = BATCH,
          mode: str = "xnor", log=None):
    """SGD over ``epochs`` passes of the training set (one forward per step)
    and one test-set evaluation per epoch. Returns (params, accuracies)."""
    dev = next(iter(_leaves(params)))[1].device
    xt, yt = (torch.from_numpy(a).to(dev) for a in data.test)
    accs = []
    for epoch in range(epochs):
        for x, y in data.batches("train", batch, seed=epoch):
            params, loss = train_step(params, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(y).to(dev), mode=mode)
        accs.append(float(H.mlp_accuracy(params, xt, yt, mode=mode)))
        if log:
            log(f"epoch {epoch}: loss={float(loss):.3f} test_acc={accs[-1] * 100:.1f}%")
    return params, accs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = SyntheticMnist(n_train=2048, n_test=512)
    params = H.mlp_init(0, hybrid=True, device=device)
    params, _ = train(params, data, log=print)

    # deploy: drop latents, pack hidden layers to 1 bit per weight
    packed = H.mlp_pack(params)
    logits = H.mlp_apply_packed(packed, torch.from_numpy(data.test[0][:8]).to(device))
    print("packed inference logits shape:", tuple(logits.shape))
    hyb, flt = H.weight_memory_bytes(hybrid=True), H.weight_memory_bytes(hybrid=False)
    print(f"deployed weight bytes: hybrid={hyb:,} vs float={flt:,} "
          f"({flt / hyb:.2f}x smaller)")


if __name__ == "__main__":
    main()
