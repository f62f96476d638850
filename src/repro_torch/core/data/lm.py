"""Text/LM data pipeline (``repro.core.data.lm``), numpy only: a byte
tokenizer, the synthetic corpus and greedy document packing.  A copy of
the reference's framework-free module, so both packages train on the
same token arrays."""

from __future__ import annotations

import numpy as np

from .dataset import Dataset


class ByteTokenizer:
    """Byte-level tokenizer with special tokens."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True,
               eos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


def synthetic_corpus(n_docs: int = 256, seed: int = 0,
                     min_len: int = 64, max_len: int = 512) -> list[str]:
    """Markov-ish synthetic text with learnable structure (not uniform
    noise: losses must visibly decrease)."""
    rng = np.random.default_rng(seed)
    words = ["the", "tensor", "backend", "swaps", "kernel", "graph", "tape",
             "memory", "pod", "mesh", "shard", "flash", "light", "scan",
             "expert", "router", "cache", "decode", "fuse", "block"]
    trans = rng.dirichlet(np.ones(len(words)) * 0.3, size=len(words))
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(min_len, max_len))
        w = int(rng.integers(len(words)))
        toks = []
        for _ in range(n):
            toks.append(words[w])
            w = int(rng.choice(len(words), p=trans[w]))
        docs.append(" ".join(toks))
    return docs


class PackedLMDataset(Dataset):
    """Greedy document packing into fixed-length token sequences.

    Sample = (tokens[seq_len], labels[seq_len]) with next-token labels;
    cross-document attention is allowed (standard packed pretraining).
    """

    def __init__(self, docs: list[str], seq_len: int,
                 tokenizer: ByteTokenizer | None = None):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.seq_len = seq_len
        stream: list[int] = []
        for d in docs:
            stream.extend(self.tokenizer.encode(d))
        n = (len(stream) - 1) // seq_len
        tok = np.asarray(stream[: n * seq_len + 1], dtype=np.int32)
        self._tokens = tok[:-1].reshape(n, seq_len)
        self._labels = tok[1:].reshape(n, seq_len)

    def __len__(self):
        return len(self._tokens)

    def __getitem__(self, idx):
        return self._tokens[idx], self._labels[idx]
