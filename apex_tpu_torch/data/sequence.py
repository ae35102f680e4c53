"""Packed-sequence LM streaming — pre-tokenized, length-packed batches
(port of :mod:`apex_tpu.data.sequence`).

The LM-side twin of :mod:`apex_tpu_torch.data.packed`: tokenization (the LM
analog of JPEG decode) happens ONCE, offline; training then gathers
fixed-shape ``[B, seq_len]`` token batches out of a memory-mapped int32
shard — pure memcpy, no tokenizer on the training host — through the
same producer/prefetch machinery
(:class:`~apex_tpu_torch.data._producer.ProducerLoader`), so the GPT trainers'
first real-data input path inherits every contract the image loaders
already prove: Megatron-sampler DP sharding, per-host ``dp_ranks``,
GLOBAL ``consumed_samples`` mid-epoch resume, preemption rewind,
``prefetch_to_device`` composition.

Packing scheme (the production pre-training layout — TorchTitan /
tf.data "packed examples"): documents are concatenated into one token
stream and reshaped into rows of ``seq_len`` with **no padding between
documents** — a row may hold several documents, and a document may span
rows.  Per-token **segment ids** (1-based per row, 0 = tail padding in
the final partial row only) mark the document boundaries so downstream
consumers can (a) mask the next-token loss at boundary crossings and (b)
build block-diagonal attention masks; with plain causal attention the
only cross-document leakage is attending back into the previous
document — the standard GPT pre-training trade.  See
:func:`segment_loss_mask` and
``transformer.testing.gpt_parallel_train.build_gpt_3d(packed_inputs=True)``.

Format (``<prefix>.tokens`` + ``<prefix>.segments`` + ``<prefix>.json``):

- ``.tokens``   — raw int32, shape [N, seq_len] (C-order);
- ``.segments`` — raw int32, shape [N, seq_len], 1-based document ids
  re-based per row, 0 = padding;
- ``.json``     — {"n", "seq_len", "n_docs", "version"} metadata.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence, Tuple

import numpy as np

from apex_tpu_torch.data._producer import ProducerLoader

__all__ = [
    "PackedSequenceDataset",
    "PackedSequenceLoader",
    "pack_token_documents",
    "segment_loss_mask",
    "synthetic_token_documents",
]


def pack_token_documents(docs: Iterable[Sequence[int]], out_prefix: str,
                         seq_len: int, *, eos_id=None,
                         drop_remainder: bool = False
                         ) -> "PackedSequenceDataset":
    """Pack pre-tokenized documents into a fixed-shape sequence shard.

    ``docs``: iterable of token id sequences (each one document, already
    tokenized — the offline stage).  ``eos_id`` (recommended) is appended
    to every document before packing, the usual document separator.
    Documents are concatenated and cut into rows of ``seq_len``; the
    final partial row is zero-padded with segment id 0 (or dropped with
    ``drop_remainder=True``).  Segment ids restart from 1 at each row so
    the id is a compact per-row document index, not a global one.

    One pass, bounded memory: each row is appended to the raw ``.tokens``
    / ``.segments`` files the moment it fills (the files are the same
    C-order bytes a ``[N, seq_len]`` memmap reads back), so packing a
    corpus never holds more than one document + one row in RAM.
    """
    if seq_len <= 1:
        raise ValueError(f"seq_len must be > 1, got {seq_len}")
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)

    cur_t = np.zeros((seq_len,), np.int32)
    cur_s = np.zeros((seq_len,), np.int32)
    fill = 0
    seg = 0  # per-row segment counter
    n = 0
    n_docs = 0
    with open(out_prefix + ".tokens", "wb") as tok_f, \
            open(out_prefix + ".segments", "wb") as seg_f:

        def flush_row():
            nonlocal n, fill
            tok_f.write(cur_t.tobytes())
            seg_f.write(cur_s.tobytes())
            cur_t[:] = 0
            cur_s[:] = 0
            fill = 0
            n += 1

        for doc in docs:
            doc = np.asarray(
                list(doc) + ([eos_id] if eos_id is not None else []),
                np.int32)
            if doc.size == 0:
                continue
            n_docs += 1
            seg += 1
            off = 0
            while off < doc.size:
                take = min(seq_len - fill, doc.size - off)
                cur_t[fill:fill + take] = doc[off:off + take]
                cur_s[fill:fill + take] = seg
                fill += take
                off += take
                if fill == seq_len:
                    flush_row()
                    # a document continuing into the next row keeps ONE
                    # logical identity but restarts the per-row counter
                    seg = 1 if off < doc.size else 0
        if fill and not drop_remainder:
            flush_row()
    if not n:
        for suffix in (".tokens", ".segments"):
            os.unlink(out_prefix + suffix)
        raise ValueError("no rows packed (empty docs?)")
    with open(out_prefix + ".json", "w") as f:
        json.dump({"n": n, "seq_len": seq_len, "n_docs": n_docs,
                   "version": 1}, f)
    return PackedSequenceDataset(out_prefix)


class PackedSequenceDataset:
    """Memory-mapped view over a packed sequence shard."""

    def __init__(self, prefix: str):
        with open(prefix + ".json") as f:
            meta = json.load(f)
        if meta.get("version") != 1:
            raise ValueError(
                f"unknown packed sequence format version: {meta}")
        self.seq_len = int(meta["seq_len"])
        self.n_docs = int(meta["n_docs"])
        self._n = int(meta["n"])
        shape = (self._n, self.seq_len)
        self.tokens = np.memmap(prefix + ".tokens", dtype=np.int32,
                                mode="r", shape=shape)
        self.segments = np.memmap(prefix + ".segments", dtype=np.int32,
                                  mode="r", shape=shape)

    def __len__(self) -> int:
        return self._n


class PackedSequenceLoader(ProducerLoader):
    """DP-sharded train iterator over a :class:`PackedSequenceDataset`.

    Yields ``(tokens int32 [B, seq_len], segments int32 [B, seq_len])``
    with ``B = local_batch * len(dp_ranks)`` and ``dp_ranks[i]``'s
    disjoint shard at rows ``[i*local : (i+1)*local]`` — the exact
    surface of the image loaders, so ``prefetch_to_device``, per-host
    sharding (``dp_ranks`` + ``dp_shard_batch(..., local_ranks=)``),
    ``DataService`` and ``consumed_samples`` checkpointing through
    ``resilience.CheckpointManager`` compose unchanged.  Feed the pair to
    ``build_gpt_3d(packed_inputs=True)``'s step or mask the loss with
    :func:`segment_loss_mask`.
    """

    def __init__(self, dataset: PackedSequenceDataset, local_batch: int,
                 data_parallel_size: int = 1, consumed_samples: int = 0,
                 seed: int = 0, prefetch: int = 2, dp_ranks=None):
        super().__init__(
            total_samples=len(dataset), local_batch=local_batch,
            data_parallel_size=data_parallel_size,
            consumed_samples=consumed_samples, seed=seed,
            prefetch=prefetch, dp_ranks=dp_ranks)
        self.dataset = dataset
        self.seq_len = dataset.seq_len

    def _gather(self, idx_per_rank) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.concatenate(idx_per_rank)
        # two fancy-index gathers out of the page cache — no tokenizer
        return (np.asarray(self.dataset.tokens[idx], np.int32),
                np.asarray(self.dataset.segments[idx], np.int32))


def segment_loss_mask(segments):
    """Next-token loss mask ``[b, s-1]`` (fp32) for packed sequences:
    position ``t`` (predicting token ``t+1``) counts iff both tokens
    belong to the same document and neither is padding (segment id 0).
    Works on numpy arrays and torch tensors (pure elementwise ops, on the
    tensor's own device)."""
    same = segments[:, 1:] == segments[:, :-1]
    real = segments[:, 1:] > 0
    mask = same & real
    if isinstance(mask, np.ndarray):
        return mask.astype(np.float32)
    import torch

    return mask.to(torch.float32)


def synthetic_token_documents(n_docs: int, vocab: int, *,
                              mean_len: int = 64, seed: int = 0):
    """Deterministic synthetic pre-tokenized corpus (list of int lists) —
    the CI/bench stand-in for a real tokenized dataset."""
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n_docs):
        n = max(1, int(rng.poisson(mean_len)))
        # reserve 0 for padding and vocab-1 for an eos the caller may use
        docs.append(rng.randint(1, max(2, vocab - 1), size=n).tolist())
    return docs
