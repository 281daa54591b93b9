"""Deterministic synthetic data with document packing (port of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``: a resumed run needs
only the step counter.  Variable-length "documents" (geometric lengths)
are drawn from a Zipf unigram model and packed into fixed-length rows,
each document ending in the EOS token 0.  The numpy draws are the
reference's, call for call (``np.random.default_rng((seed, step))``),
so each ``(seed, step)`` gives the reference's batch exactly.

:class:`PrefetchLoader` makes batches on a background thread, ahead of
the step that consumes them; the train loop's moves each onto the
run's device."""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["PackedSyntheticData", "PrefetchLoader", "batch_to_device"]


class PackedSyntheticData:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec | str,
                 seed: int = 0, mean_doc_len: int = 256):
        self.cfg = cfg
        self.shape = SHAPES[shape] if isinstance(shape, str) else shape
        self.seed = seed
        self.mean_doc_len = mean_doc_len
        v = max(cfg.vocab, 2)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)  # Zipf unigrams
        self._eos = 0

    def batch(self, step: int) -> dict:
        """The batch of ``step``: numpy arrays (``tokens`` and
        ``labels`` int32 of shape (batch, seq); the encoder and vlm
        families' extra arrays as in the reference)."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.shape.global_batch, self.shape.seq_len
        if self.cfg.family == "encoder":
            feats = rng.standard_normal(
                (b, s, self.cfg.frontend_dim)).astype(np.float32)
            labels = rng.integers(0, self.cfg.vocab, (b, s), dtype=np.int64)
            return {"features": feats, "labels": labels.astype(np.int32)}
        tokens = np.empty((b, s), np.int64)
        for i in range(b):
            row, fill = [], 0
            while fill < s:
                ln = min(1 + rng.geometric(1.0 / self.mean_doc_len),
                         s - fill)
                doc = rng.choice(len(self._probs), size=ln, p=self._probs)
                doc[-1] = self._eos  # document boundary
                row.append(doc)
                fill += ln
            tokens[i] = np.concatenate(row)[:s]
        out = {"tokens": tokens.astype(np.int32),
               "labels": tokens.astype(np.int32)}
        if self.cfg.family == "vlm":
            nv = min(self.cfg.frontend_tokens, s // 2)
            out["vision_embeds"] = rng.standard_normal(
                (b, nv, self.cfg.frontend_dim)).astype(np.float32)
            m = np.ones((b, s), np.float32)
            m[:, :nv] = 0.0
            out["loss_mask"] = m
        return out


def batch_to_device(batch: dict, device) -> dict:
    """numpy arrays -> torch tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class PrefetchLoader:
    """Background-thread prefetch of ``dataset.batch(step)``, yielding
    ``(step, batch)`` from ``start_step`` on.  Each batch passes through
    ``put_fn`` on the worker thread (the train loop's moves it onto the
    run's device with :func:`batch_to_device`).  An exception in the
    worker is raised by the next ``next()``."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2,
                 put_fn=None):
        self.dataset = dataset
        self.put_fn = put_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self.put_fn(self.dataset.batch(step)))
            except Exception as e:  # noqa: BLE001 -- handed to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)
