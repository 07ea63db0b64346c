"""The hybrid Whitener -> Oja -> readout MNIST benchmark on the port
(counterpart of `benchmarks/bench_mnist.py`, which runs the same math in
batched JAX with optax): a running whitener and an Oja Hebbian layer
(`training/online.py`) learn over the training stream without labels,
then a linear readout on the frozen basis learns with `torch.optim.Adam`.

Data: MNIST from `--data` (an .npz with x_train, y_train, x_test,
y_test), else keras's cached `~/.keras/datasets/mnist.npz` when it
exists; otherwise the handwritten digits sklearn bundles (8 x 8, 1,797
samples; UCI's optdigits test set) as an offline stand-in, split and
normalised as the JAX script does. The port keeps its own copy of those
digits and of that split (sklearn's stratified `train_test_split`,
test_size 0.25, random_state 0) in `_data/digits.npz`, so it needs no
sklearn. Nothing is downloaded.

    python -m aura_snn_rag_tpu_torch.bench_mnist [--epochs 5]
        [--hidden 1024] [--batch 64] [--oja-eta 0.001] [--lr 5e-4]
        [--data mnist.npz] [--device cuda]

Prints one progress line per readout epoch, then one JSON object with the
JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.training.online import (
    OjaState, init_oja, init_whitener, oja_forward, oja_step, whiten,
    whiten_update)

DIGITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_data",
                      "digits.npz")


def load_data(path: Optional[str] = None):
    """-> (x_train, y_train, x_test, y_test, source name)."""
    candidates = ([path] if path else
                  [os.path.expanduser("~/.keras/datasets/mnist.npz")])
    for path in candidates:
        if os.path.exists(path):
            d = np.load(path)
            xtr = d["x_train"].reshape(-1, 784).astype(np.float32) / 255.0
            xte = d["x_test"].reshape(-1, 784).astype(np.float32) / 255.0
            # the reference's normalisation
            xtr = (xtr - 0.1307) / 0.3081
            xte = (xte - 0.1307) / 0.3081
            return xtr, d["y_train"], xte, d["y_test"], "mnist"
    digits = np.load(DIGITS)
    x = (digits["data"] / 16.0).astype(np.float32)
    x = (x - x.mean()) / (x.std() + 1e-8)
    y = digits["target"].astype(np.int64)
    tr, te = digits["train_idx"], digits["test_idx"]
    return x[tr], y[tr], x[te], y[te], "sklearn-digits (offline MNIST proxy)"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--oja-eta", type=float, default=0.001)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--data", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def learn_basis(x: torch.Tensor, whitener, oja, epochs: int, batch: int,
                oja_eta: float, rng: np.random.RandomState):
    """Phase 1: the whitener and Oja learn without labels over `epochs`
    passes of `x` [n, D], each in an order `rng` draws; returns the new
    (whitener, oja)."""
    n = x.shape[0]
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(x.device)
        for i in range(0, n - batch + 1, batch):
            whitener, xw = whiten_update(whitener, x[order[i:i + batch]])
            oja, _ = oja_step(oja, xw, eta=oja_eta)
    return whitener, oja


def run(epochs: int = 5, hidden: int = 1024, batch: int = 64,
        oja_eta: float = 0.001, lr: float = 5e-4, device="cuda",
        data: Optional[str] = None,
        oja: Optional[OjaState] = None) -> dict:
    """The benchmark; returns its JSON object. `oja` is the Oja layer to
    start from (on `device`, at `min(hidden, D)` components); by default
    it is drawn from a generator seeded 0."""
    dev = resolve_device(device)
    xtr, ytr, xte, yte, source = load_data(data)
    D = xtr.shape[1]
    n_classes = int(ytr.max()) + 1
    # Oja is a subspace (PCA-like) rule: an over-complete basis makes the
    # residual explode and neurogenesis run away, so at most D components
    hidden = min(hidden, D)
    print(f"data: {source}  train={xtr.shape} test={xte.shape} "
          f"components={hidden}", flush=True)

    t0 = time.time()
    if oja is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        oja = init_oja(gen, D, hidden,
                       max_components=max(2 * hidden, hidden + 8),
                       device=dev)
    xtr_d = torch.from_numpy(xtr).to(dev)
    xte_d = torch.from_numpy(xte).to(dev)
    rng = np.random.RandomState(0)
    n = len(xtr)
    whitener, oja = learn_basis(xtr_d, init_whitener(D, device=dev), oja,
                                epochs, batch, oja_eta, rng)

    # phase 2: a linear readout on the frozen basis
    feats_tr = oja_forward(oja, whiten(whitener, xtr_d))
    feats_te = oja_forward(oja, whiten(whitener, xte_d))
    W = torch.zeros(feats_tr.shape[1], n_classes, device=dev,
                    requires_grad=True)
    b = torch.zeros(n_classes, device=dev, requires_grad=True)
    opt = torch.optim.Adam([W, b], lr=lr * 10)
    ytr_d = torch.from_numpy(np.asarray(ytr)).long().to(dev)
    yte_d = torch.from_numpy(np.asarray(yte)).long().to(dev)
    test_acc = 0.0
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n - batch + 1, batch):
            rows = order[i:i + batch]
            loss = torch.nn.functional.cross_entropy(
                feats_tr[rows] @ W + b, ytr_d[rows])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            preds = (feats_te @ W + b).argmax(-1)
            test_acc = float((preds == yte_d).float().mean())
        print(f"epoch {epoch + 1}: loss="
              f"{float(torch.stack(losses).mean()):.4f} "
              f"test_acc={test_acc * 100:.2f}%", flush=True)

    return {
        "metric": "hybrid Whitener->Oja->readout test accuracy",
        "value": round(test_acc * 100, 2), "unit": "%",
        "dataset": source, "epochs": epochs,
        "reference_published": 94.34, "elapsed_s": round(time.time() - t0),
        "active_components": int(oja.K),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    result = run(args.epochs, args.hidden, args.batch, args.oja_eta,
                 args.lr, args.device, args.data)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
