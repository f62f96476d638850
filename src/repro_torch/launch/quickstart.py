"""Quickstart: the paper's end-to-end example (Appendix A.4.3), the twin
of ``examples/quickstart.py`` on the port's core stack: a Sequential CNN
on synthetic "digits", SGD with momentum through ``loss.backward();
opt.step(); opt.zeroGrad()``, loss and error meters, train and eval
loops, all under one session.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--backend hopper]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import nn
from repro_torch.core.autograd import noGrad
from repro_torch.core.data import BatchDataset, TensorDataset
from repro_torch.core.optim import SGDOptimizer
from repro_torch.runtime import resolve_device

IMAGE_DIM, CLASSES, BATCH = 12, 10, 64


def load_dataset(seed=0, n=2048, image_dim=IMAGE_DIM, classes=CLASSES):
    """Synthetic 'digits': class-dependent blobs on an image grid (the
    reference's generator, so both packages see the same data)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, classes, n)
    xs = rng.standard_normal((n, image_dim, image_dim, 1)) * 0.3
    for i, y in enumerate(ys):
        r, c = divmod(int(y), 4)
        xs[i, 2 + 2 * r: 5 + 2 * r, 2 + 2 * c: 5 + 2 * c, 0] += 1.5
    return xs.astype(np.float32), ys.astype(np.int32)


def build_model(device="cuda") -> nn.Sequential:
    """The reference's CNN; parameter names ``m0.weight`` ... ``m10.bias``."""
    return nn.Sequential(
        nn.Conv2D(1, 8, 3, 3, device=device), nn.ReLU(),
        nn.Pool2D(2, 2, 2, 2),
        nn.Conv2D(8, 16, 3, 3, device=device), nn.ReLU(),
        nn.Pool2D(2, 2, 2, 2),
        nn.View((-1, 3 * 3 * 16)),
        nn.Linear(3 * 3 * 16, 64, device=device), nn.ReLU(), nn.Dropout(0.1),
        nn.Linear(64, CLASSES, device=device), nn.LogSoftmax())


def _batch(bx, by, device):
    return (noGrad(torch.from_numpy(bx).to(device)),
            noGrad(torch.from_numpy(by).long().to(device)))


def eval_loop(model, dataset, device) -> tuple[float, float]:
    """Mean loss and error (%) over ``dataset``, dropout off."""
    loss_meter, err_meter, n = 0.0, 0.0, 0
    model.eval()
    for bx, by in dataset:
        inputs, target = _batch(bx, by, device)
        output = model(inputs)
        pred = torch.argmax(output.tensor(), dim=-1)
        err_meter += float((pred != target.data).sum())
        loss = nn.categoricalCrossEntropy(output, target)
        loss_meter += float(loss.tensor()) * len(by)
        n += len(by)
    model.train()
    return loss_meter / n, 100.0 * err_meter / n


def train(model, trainset, valset, *, epochs: int, device, log=print):
    """The reference's loop: SGD lr 0.1 momentum 0.9, one ``step`` and
    ``zeroGrad`` per batch; returns the last (val_loss, val_err)."""
    opt = SGDOptimizer(model.params(), lr=0.1, momentum=0.9)
    val_loss = val_err = float("nan")
    for epoch in range(epochs):
        train_loss, nb = 0.0, 0
        for bx, by in trainset:
            inputs, target = _batch(bx, by, device)
            loss = nn.categoricalCrossEntropy(model(inputs), target)
            train_loss += float(loss.tensor())
            nb += 1
            loss.backward()
            opt.step()
            opt.zeroGrad()
        val_loss, val_err = eval_loop(model, valset, device)
        log(f"Epoch {epoch}: Avg Train Loss: {train_loss / nb:.4f} "
            f"Validation Loss: {val_loss:.4f} "
            f"Validation Error (%): {val_err:.2f}")
    return val_loss, val_err


def run(*, backend: str = "torch", device="cuda", epochs: int = 4,
        n: int = 2048, log=print) -> tuple[float, float]:
    """The quickstart at the reference's size (n 2048: 256 validation
    images, 28 training batches of 64, 4 epochs) under
    ``session(backend=backend)``; returns (val_loss, val_err)."""
    dev = resolve_device(device)
    with repro_torch.session(backend=backend, tag="quickstart"):
        xs, ys = load_dataset(n=n)
        val = BatchDataset(TensorDataset([xs[:256], ys[:256]]), BATCH)
        trn = BatchDataset(TensorDataset([xs[256:], ys[256:]]), BATCH)
        return train(build_model(dev), trn, val, epochs=epochs, device=dev,
                     log=log)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, val_err = run(backend=args.backend, device=args.device)
    if not val_err < 20.0:
        raise SystemExit(f"training failed: validation error {val_err:.2f} %")
    print("quickstart OK")


if __name__ == "__main__":
    main()
