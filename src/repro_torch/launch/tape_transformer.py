"""The core stack's transformer, trained through the tape: the twin of
the ``bert_like`` family of the reference's overhead benchmark
(``_tape_transformer`` in ``benchmarks/bench_overhead.py``).

``nn.Embedding(vocab, d)``, ``layers`` x ``nn.TransformerBlock(d, heads)``
(LayerNorm, 4d GELU MLP), ``nn.Linear(d, vocab)`` and
``categoricalCrossEntropy`` over every token, in fp32.  Parameter names
are the reference container's (``m0.weight`` for the embedding, ``m1`` ..
``m{layers}`` the blocks, the head last), so weights cross with
``repro_torch.convert.module_params``.  Under ``session(backend="hopper")``
every matmul of its forward and tape backward launches the Hopper matmul
kernel: ``matmuls_per_step`` of them a step.
"""

from __future__ import annotations

from repro_torch.core import nn
from repro_torch.core.autograd import Variable
from repro_torch.core.autograd import functions as F


class TapeTransformer:
    """The embedding, the blocks and the head, held in one
    ``nn.Container`` for their parameters."""

    def __init__(self, d: int, heads: int, layers: int, vocab: int, *,
                 seed: int = 0, device="cuda"):
        self.blocks = [nn.TransformerBlock(d, heads, key=seed + i,
                                           device=device)
                       for i in range(layers)]
        self.emb = nn.Embedding(vocab, d, key=seed + 99, device=device)
        self.head = nn.Linear(d, vocab, key=seed + 100, device=device)
        self.container = nn.Container(self.emb, *self.blocks, self.head)
        self.vocab = vocab

    def loss(self, toks, labels) -> Variable:
        """Mean token cross-entropy of ``toks`` [B, S] against ``labels``
        [B, S] (integer tensors on the parameters' device)."""
        b, s = toks.shape
        h = self.emb(toks)
        for blk in self.blocks:
            h = blk(h)
        logits = self.head(h)
        return nn.categoricalCrossEntropy(
            F.reshape(logits, (b * s, self.vocab)),
            Variable(labels.reshape(-1)))

    def matmuls_per_step(self) -> int:
        """``ops.matmul`` calls of one forward and tape backward: per block
        q, k, v, o, ff1, ff2 and the two attention products, plus the
        head; the backward makes two per forward product."""
        return 3 * (8 * len(self.blocks) + 1)
