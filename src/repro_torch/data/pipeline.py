"""Deterministic synthetic data pipeline: sharded, resumable, prefetching
(port of ``repro/data/pipeline.py``).

The stream is an n-gram-like synthetic LM stream with enough structure for
the loss to fall.  ``batch(step)`` is a pure function of the step, drawn
from numpy generators seeded exactly as the reference seeds them, so the
port's batches equal the reference's value for value and a restart at
step N replays the identical stream.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of "
                             f"n_hosts {self.n_hosts}")
        return self.global_batch // self.n_hosts


class SyntheticLMStream:
    """Step-indexed deterministic batches: ``batch(step)`` is a pure
    function, so restart-at-step-N replays the identical stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Sparse-ish Markov transition structure => learnable signal.
        self._shift = rng.integers(1, max(2, v - 1))
        self._mix = rng.integers(0, v, size=(256,))

    def batch_numpy(self, step: int) -> dict:
        """The reference's batch as int32 numpy arrays (host_batch, seq_len)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 4099 + cfg.host_id)
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        start = rng.integers(0, v, size=(b, 1))
        noise = rng.integers(0, v, size=(b, s + 1))
        drift = np.cumsum(np.ones((b, s + 1), np.int64), axis=1) * self._shift
        seq = (start + drift + (noise // 16) * self._mix[noise % 256]) % v
        # 7/8 of tokens follow the deterministic pattern; 1/8 noise.
        use_noise = rng.random((b, s + 1)) < 0.125
        seq = np.where(use_noise, noise, seq)
        return {"tokens": seq[:, :-1].astype(np.int32), "labels": seq[:, 1:].astype(np.int32)}

    def batch(self, step: int, device="cuda") -> dict:
        """The batch at ``step`` as int64 tensors (torch's index dtype) on
        ``device``."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                for k, v in self.batch_numpy(step).items()}


class PrefetchIterator:
    """Background-thread prefetch of the step-indexed stream: yields
    (step, batch on ``device``) from ``start_step`` on."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0, depth: int = 2,
                 device="cuda"):
        self._stream = stream
        self._step = start_step
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._stream.batch(step, self._device))
            except Exception as e:  # noqa: BLE001 -- handed to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __next__(self):
        """(step, batch); a batch that failed to build raises here."""
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
