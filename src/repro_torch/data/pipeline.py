"""Data pipeline: a deterministic synthetic stream and a host-side
prefetcher.

The CPU role the paper worries about (§V-A: "getting the training datasets
ready to be fed into the accelerators") lives here: batches are produced on
a host thread, pinned, and copied to the card ahead of use, so the input
pipeline overlaps the step.  ``SyntheticLM.batch_at`` is numpy only and
byte-identical to the reference's, the frontends' frames and patches
included; so is the file-backed ``MemmapTokens``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontends


class SyntheticLM:
    """Deterministic, stateless-by-step synthetic LM stream.

    Batch t is a pure function of (seed, t): resuming at step t after a
    restart reproduces the identical stream with no replay buffer (the
    checkpointable ``get_state``/``set_state`` come with checkpointing,
    slice 4).
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
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
        d = {"tokens": tokens, "labels": labels, "positions": pos}
        if cfg.frontend == "audio_stub":
            d["frames"] = rng.standard_normal(
                (B, cfg.frontend_tokens, frontends.AUDIO_FRAME_DIM),
                dtype=np.float32)
        if cfg.frontend == "vision_stub":
            d["patches"] = rng.standard_normal(
                (B, cfg.frontend_tokens, frontends.VISION_PATCH_DIM),
                dtype=np.float32)
            d["labels"][:, :cfg.frontend_tokens] = -1   # no CE on patches
        return d

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        while True:
            t = self.step
            self.step += 1
            yield t, self.batch_at(t)


class MemmapTokens:
    """File-backed token stream (a binary int32 file), windowed batches:
    batch t takes ``batch`` windows of ``seq`` tokens at offsets drawn
    from (seed, t), labels the same windows one token on."""

    def __init__(self, path: str, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.step = 0
        self.n_windows = max(1, (len(self.tokens) - 1) // seq)

    def batch_at(self, t: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, t]))
        idx = rng.integers(0, self.n_windows, size=(self.batch,))
        S = self.seq
        toks = np.stack([self.tokens[i * S:(i + 1) * S] for i in idx])
        labels = np.stack([self.tokens[i * S + 1:(i + 1) * S + 1]
                           for i in idx])
        pos = np.broadcast_to(np.arange(S, dtype=np.int32),
                              (self.batch, S)).copy()
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32), "positions": pos}

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        while True:
            t = self.step
            self.step += 1
            yield t, self.batch_at(t)


def host_tensors(batch: Dict[str, np.ndarray], pin: bool
                 ) -> Dict[str, torch.Tensor]:
    """A numpy batch as host tensors, in pinned memory when ``pin``:
    integer arrays as int64 (indices for the embedding gather and the CE
    pick), float arrays (frames, patches) as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
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
