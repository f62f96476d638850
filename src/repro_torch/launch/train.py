"""End-to-end training launcher for the port.

  python -m repro_torch.launch.train --arch codeqwen1.5-7b --reduced \
      --device cpu --steps 5

It runs on the card unless ``--device cpu`` is given, and raises when no
card is there.  ``--layers N`` cuts the depth of a full-width config
(widths stay the published ones).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.data import (BatchDataset, PackedLMDataset,
                                   PrefetchDataset, ShuffleDataset,
                                   synthetic_corpus)
from repro_torch.core.optim import AdamW
from repro_torch.models import build_model
from repro_torch.models.meta import tree_leaves
from repro_torch.training.train_loop import TrainConfig, train


def make_batches(cfg, batch_size: int, seq: int, steps: int, seed: int = 0):
    """Data pipeline: synthetic corpus -> packed tokens -> shuffled batches
    -> background prefetch; token ids are folded into the model vocab.
    Yields ``{"tokens", "labels"}`` int32 numpy ``[B, S]`` (dense decoders
    only: the reference's encoder-decoder and VLM extras are not ported)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"make_batches: family {cfg.family!r} "
                                  "is not ported")
    docs = synthetic_corpus(n_docs=512, seed=seed)
    ds = PackedLMDataset(docs, seq_len=seq)
    ds = ShuffleDataset(ds, seed=seed)
    batched = PrefetchDataset(BatchDataset(ds, batch_size), buffer_size=4)
    epoch = 0
    produced = 0
    while produced < steps:
        for tokens, labels in batched:
            yield {"tokens": np.asarray(tokens) % cfg.vocab_size,
                   "labels": np.asarray(labels) % cfg.vocab_size}
            produced += 1
            if produced >= steps:
                return
        epoch += 1
        ds.reshuffle(epoch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    model = build_model(cfg, device=args.device)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"device={model.device}")
    params = model.init(0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] params: {n_params/1e6:.2f}M")

    tcfg = TrainConfig(steps=args.steps, base_lr=args.lr,
                       checkpoint_dir=args.ckpt,
                       warmup=max(2, args.steps // 20))
    batches = make_batches(cfg, args.batch, args.seq, args.steps)
    params, history = train(model, params, batches, tcfg,
                            optimizer=AdamW(lr=args.lr))
    k = max(1, min(5, len(history) // 2))
    first = np.mean([h["loss"] for h in history[:k]])
    last = np.mean([h["loss"] for h in history[-k:]])
    print(f"[train] loss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"(mean of the first and last {k})")
    return history


if __name__ == "__main__":
    main()
