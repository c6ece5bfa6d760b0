"""Deterministic synthetic LM data pipeline: the port's own copy of
``repro/data/pipeline.py``, typed against the port's ``ModelConfig``.  It
gives the same batches, bit for bit (a test holds the two equal).

Production shape: seeded shard-deterministic token sampling (each (step,
host) pair regenerates identical data — the property fault-tolerant restart
relies on), sequence packing of variable-length documents, prefetch via a
background thread, and modality-stub extras for VLM/audio archs.

Determinism contract: ``batch_at(step)`` is a pure function of (seed, step),
so a restarted job replays the exact token stream without coordination —
the data-plane half of checkpoint/restart.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 256
    # synthetic document length distribution (for packing)
    mean_doc_len: int = 180
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2


class SyntheticLMDataset:
    """Packed synthetic documents with a learnable structure (a noisy
    modular-arithmetic sequence) so training loss measurably decreases."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.vocab = model_cfg.vocab_size

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(int(rng.exponential(self.cfg.mean_doc_len)), 8)
        start = rng.integers(3, max(self.vocab // 4, 4))
        step = rng.integers(1, 7)
        toks = (start + step * np.arange(n)) % max(self.vocab - 3, 1) + 3
        noise = rng.random(n) < 0.05
        toks = np.where(noise, rng.integers(3, self.vocab, n), toks)
        return np.concatenate([[self.cfg.bos_id], toks, [self.cfg.eos_id]])

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): the restart-replay contract."""
        rng = np.random.default_rng((self.cfg.seed << 20) ^ step)
        b, s = self.cfg.global_batch, self.cfg.seq_len
        tokens = np.full((b, s), self.cfg.pad_id, dtype=np.int32)
        for i in range(b):
            pos = 0
            while pos < s:  # sequence packing
                doc = self._doc(rng)
                take = min(len(doc), s - pos)
                tokens[i, pos : pos + take] = doc[:take]
                pos += take
        labels = tokens.copy()
        batch = {"tokens": tokens, "labels": labels}
        mc = self.model_cfg
        if mc.family == "vlm":
            batch["image_embeds"] = rng.standard_normal(
                (b, mc.n_image_tokens, mc.d_model), dtype=np.float32)
        if mc.family == "audio":
            enc_len = max(int(s * mc.encoder_len_ratio), 16)
            batch["audio_frames"] = rng.standard_normal(
                (b, enc_len, mc.d_model), dtype=np.float32)
        return batch


def make_batches(ds: SyntheticLMDataset, start_step: int = 0,
                 prefetch: int = 2) -> Iterator[dict]:
    """Background-thread prefetching iterator starting at ``start_step``
    (restart replays from the checkpointed step)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
