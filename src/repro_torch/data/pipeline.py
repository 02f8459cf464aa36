"""Data pipeline: a deterministic synthetic stream and a host-side
prefetcher.

The CPU role the paper worries about (§V-A: "getting the training datasets
ready to be fed into the accelerators") lives here: batches are produced on
a host thread, pinned, and copied to the card ahead of use, so the input
pipeline overlaps the step.  ``SyntheticLM.batch_at`` is numpy only and
byte-identical to the reference's.  The file-backed ``MemmapTokens`` and
the frontends' frames and patches port with later slices.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Deterministic, stateless-by-step synthetic LM stream.

    Batch t is a pure function of (seed, t): resuming at step t after a
    restart reproduces the identical stream with no replay buffer (the
    checkpointable ``get_state``/``set_state`` come with checkpointing,
    slice 4).
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: frontend frames / patches port with slice 3d")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.step = 0

    def batch_at(self, t: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, t]))
        B, S, V = self.batch, self.seq, cfg.vocab_size
        # markov-ish stream so the loss is learnable (not pure noise)
        base = rng.integers(0, V, size=(B, 1), dtype=np.int32)
        drift = rng.integers(0, 17, size=(B, S), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % V
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1                       # no target for last pos
        if cfg.mrope_sections:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32),
                                  (3, B, S)).copy()
        else:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        return {"tokens": tokens, "labels": labels, "positions": pos}

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        while True:
            t = self.step
            self.step += 1
            yield t, self.batch_at(t)


def host_tensors(batch: Dict[str, np.ndarray], pin: bool
                 ) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 host tensors (indices for the embedding
    gather and the CE pick), in pinned memory when ``pin``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).long()
        out[k] = t.pin_memory() if pin else t
    return out


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``; a card's copy is staged through pinned
    memory and does not block the host."""
    pin = torch.device(device).type == "cuda"
    return {k: v.to(device, non_blocking=pin)
            for k, v in host_tensors(batch, pin).items()}


class Prefetcher:
    """Host-thread double buffering around any (step, batch) iterator.

    The worker thread converts each numpy batch to int64 tensors in pinned
    host memory (when the device is a card); iteration copies it to the
    device with ``non_blocking=True`` on the current stream."""

    def __init__(self, source, device, depth: int = 2):
        self.source = source
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        for t, batch in self.source:
            if self._stop.is_set():
                break
            host = host_tensors(batch, self.pin)
            while not self._stop.is_set():
                try:
                    self.q.put((t, host), timeout=0.25)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        while not self._stop.is_set():
            t, host = self.q.get()
            yield t, {k: v.to(self.device, non_blocking=self.pin)
                      for k, v in host.items()}

    def close(self):
        self._stop.set()
