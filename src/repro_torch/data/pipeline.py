"""Data pipeline: deterministic, step-indexed, resumable (the reference's
`repro.data.pipeline`; the same numpy draws, so batch k is the reference's
batch k bit for bit).

SyntheticTokens    - step-seeded token stream (restart at step k reproduces
                     exactly the batch k; required by RestartManager).
PackedFileDataset  - memmap-backed binary token shards with sequence packing.
Prefetcher         - background-thread prefetch (overlap the input
                     pipeline with compute).

Batches are dicts of tensors on `device` (None: CUDA; "cpu" runs there).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


class SyntheticTokens:
    """Deterministic synthetic LM batches; batch k depends only on (seed, k)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 n_codebooks: int = 0, patch_prefix: int = 0,
                 d_model: int = 0, seed: int = 0, device=None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.n_codebooks = n_codebooks
        self.patch_prefix = patch_prefix
        self.d_model = d_model
        self.seed = seed
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        text = self.seq_len - self.patch_prefix
        if self.n_codebooks:
            tok = rng.integers(0, self.vocab_size,
                               (self.batch, text, self.n_codebooks))
        else:
            tok = rng.integers(0, self.vocab_size, (self.batch, text))
        out = {"tokens": torch.from_numpy(tok.astype(np.int32)).to(
            self.device)}
        if self.patch_prefix:
            pe = rng.standard_normal((self.batch, self.patch_prefix,
                                      self.d_model))
            out["patch_embeds"] = torch.from_numpy(pe).to(
                torch.bfloat16).to(self.device)
        return out


class PackedFileDataset:
    """Binary uint16/uint32 token shards, packed into fixed-length sequences.

    File layout: flat token stream; sequence k = tokens[k*S : (k+1)*S].
    Deterministic shuffling by step-seeded permutation over sequence index.
    """

    def __init__(self, path: str, batch: int, seq_len: int, *,
                 dtype=np.uint16, seed: int = 0, device=None):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq_len = seq_len
        self.n_seqs = len(self.tokens) // seq_len
        self.seed = seed
        self.device = resolve_device(device)
        if self.n_seqs < batch:
            raise ValueError("dataset smaller than one batch")

    @staticmethod
    def write(path: str, tokens: np.ndarray, dtype=np.uint16):
        tokens.astype(dtype).tofile(path)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.choice(self.n_seqs, size=self.batch, replace=False)
        seqs = np.stack([
            self.tokens[i * self.seq_len:(i + 1) * self.seq_len]
            for i in idx])
        return {"tokens": torch.from_numpy(seqs.astype(np.int32)).to(
            self.device)}


class Prefetcher:
    """Wraps a step-indexed data fn with a background prefetch thread."""

    def __init__(self, data_fn: Callable[[int], dict], depth: int = 2):
        self.data_fn = data_fn
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next_submit = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def start(self, from_step: int = 0):
        self._next_submit = from_step
        self._stop = False

        def work():
            while not self._stop:
                step = self._next_submit
                batch = self.data_fn(step)
                self.q.put((step, batch))
                with self._lock:
                    self._next_submit += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def get(self, step: int) -> dict:
        while True:
            got_step, batch = self.q.get()
            if got_step == step:
                return batch
            # restart skew: drop stale prefetches

    def stop(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
