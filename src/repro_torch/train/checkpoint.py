"""Sharded, atomic, tier-backed checkpoints.

Numpy archives and a JSON manifest, in the reference's layout
(``repro/train/checkpoint.py``): the same npz members (leaf keys joined by
``::``, a codec scale under ``<key>::scale``), manifest keys and
``payload_dtype`` strings, bfloat16 and float8 payloads stored as raw
2- and 1-byte records (numpy's ``V2`` / ``V1``, which is how the
reference's ``ml_dtypes`` arrays read back).  Each package restores a
directory the other wrote.

* **checkpoint-as-a-tier**: snapshots flow through a
  :class:`~repro_torch.core.runtime.MemoryRuntime` whose tier stack is the
  :class:`~repro_torch.core.tiers.CheckpointTier` (host or pooled backing
  store, optional codec), metered as ``ckpt_save`` / ``ckpt_load``.  The
  manifest accounts the same raw / wire bytes the meter counts.
* **atomic**: written to ``<dir>/tmp.<step>`` then ``os.replace``d into
  ``<dir>/step_<n>``; stale ``tmp.*`` orphans of a crashed save are swept
  on the next save.
* **sharded + CRC-validated**: leaves are packed into ``shards`` npz files
  balanced by bytes, the manifest records a crc32 per shard, and
  :meth:`CheckpointManager.restore` raises :class:`CheckpointError`
  (``restore_latest`` skips and warns) on a missing or corrupt manifest
  or shard.
* **async saves**: the encode through the tier and the copy to host
  memory are synchronous (the train step updates the parameters and
  moments in place, so nothing may read them after ``save`` returns); the
  write, CRC and commit overlap the next steps in a thread.  At most one
  save is in flight (:meth:`CheckpointManager.wait` joins and re-raises).
* **keep-K** garbage collection.
* the data stream's state rides along in the manifest.
"""
from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.tiers import SpillPayload, TransferHints

log = logging.getLogger(__name__)
Pytree = Any

_SEP = "::"
_SCALE_SUFFIX = "::scale"
# dtypes numpy has no name for travel as raw records of their size
_RAW_DTYPES = {torch.bfloat16: np.dtype("V2"),
               torch.float8_e4m3fn: np.dtype("V1")}
_RAW_VIEW = {2: np.int16, 1: np.uint8}


class CheckpointError(RuntimeError):
    """A checkpoint directory failed validation (missing/corrupt manifest,
    missing shard, CRC mismatch).  ``restore_latest`` skips past these."""


def _flatten(state: Pytree) -> Dict[str, Any]:
    """``{"a::b::c": leaf}`` in the reference's key order."""
    leaves, paths = tree.flatten(state)
    return {_SEP.join(str(k) for k in path): leaf
            for leaf, path in zip(leaves, paths)}


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's (numpy / ml_dtypes) name of a torch dtype."""
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointError(f"unknown dtype {name!r} in the manifest")
    return dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array the archive stores."""
    if t.dtype in _RAW_DTYPES:
        view = {2: torch.int16, 1: torch.uint8}[t.element_size()]
        return t.view(view).numpy().view(_RAW_DTYPES[t.dtype])
    return t.numpy()


def _contiguous(arr: np.ndarray) -> torch.Tensor:
    # np.ascontiguousarray turns a 0-d array into a 1-d one
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def from_numpy(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """An archive member as a host tensor of the manifest's dtype."""
    dtype = torch_dtype(dtype_str)
    if arr.dtype.kind == "V":
        return _contiguous(arr.view(_RAW_VIEW[arr.dtype.itemsize])).view(
            dtype)
    return _contiguous(arr).to(dtype)


def _host_copy(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t`` (a payload) as host memory the caller owns: copied off the
    card, or cloned where it still shares the live leaf's storage."""
    if t.device.type != "cpu":
        return t.cpu()
    if t.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        return t.clone()
    return t


def make_ckpt_runtime(ckpt, plan, memory, device, keep: int = 1):
    """The snapshot runtime of a :class:`CheckpointPlan`: the requested
    backing store behind the CheckpointTier drain, the snapshot codec on
    top (core.tiers.build_ckpt_tier), on ``device``."""
    from repro_torch.core.runtime import MemoryRuntime
    from repro_torch.core.tiers import build_ckpt_tier
    tier = build_ckpt_tier(memory, plan, device, backing=ckpt.tier,
                           codec=ckpt.codec, keep=keep)
    return MemoryRuntime(plan, memory, device, tier=tier)


class CheckpointManager:
    """Snapshot writer/reader over a checkpoint-tier runtime.

    runtime: a :class:`~repro_torch.core.runtime.MemoryRuntime` whose tier
    is a CheckpointTier stack (:func:`make_ckpt_runtime`); None writes
    host copies of the leaves directly, un-metered (the legacy path).
    on_commit: callback ``(step, final_dir)`` invoked after the atomic
    rename — the chaos harness corrupts a committed shard through it.
    ``stats`` keeps the seconds of each save's encode (``encode_s``, the
    caller's), write + CRC + commit (``write_s``, the writer thread's) and
    each restore (``restore_s``).
    """

    def __init__(self, directory: str, keep: int = 3,
                 runtime=None, shards: int = 1,
                 async_saves: bool = False,
                 on_commit: Optional[Callable[[int, str], None]] = None):
        self.dir = directory
        self.keep = keep
        self.runtime = runtime
        self.shards = max(1, shards)
        self.async_saves = async_saves
        self.on_commit = on_commit
        self.stats: Dict[str, List[float]] = {
            "encode_s": [], "write_s": [], "restore_s": []}
        self._inflight: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def in_flight(self) -> bool:
        """Whether an async save is still writing."""
        return self._inflight is not None and self._inflight.is_alive()

    # ------------------------------------------------------------------
    # save path
    def _encode(self, state: Pytree) -> Tuple[Dict[str, np.ndarray],
                                              List[Dict[str, Any]],
                                              Dict[str, float]]:
        """Push every leaf through the snapshot tier and bring the payloads
        to host numpy arrays the manager owns.  Synchronous: the host
        tier's copies off the card are asynchronous, so this waits for
        them before any payload is read, and what it returns shares no
        storage with the state the next step updates in place."""
        staged = []
        for key, leaf in _flatten(state).items():
            if leaf is None:
                continue
            leaf = leaf.detach()
            if self.runtime is not None:
                q, scale = self.runtime.snapshot(
                    leaf, TransferHints(dtype=leaf.dtype, name=key))
                if isinstance(q, SpillPayload):
                    q = q.inner[0]
            else:
                q, scale = leaf, None
            staged.append((key, leaf, q, scale))
        if any(leaf.is_cuda for _, leaf, _, _ in staged):
            torch.cuda.synchronize()
        arrays: Dict[str, np.ndarray] = {}
        entries: List[Dict[str, Any]] = []
        raw_total = wire_total = 0.0
        for key, leaf, q, scale in staged:
            q_np = to_numpy(_host_copy(q, leaf))
            arrays[key] = q_np
            entry = {"key": key, "dtype": dtype_name(leaf.dtype),
                     "shape": list(leaf.shape),
                     "payload_dtype": dtype_name(q.dtype),
                     "nbytes": int(q_np.nbytes)}
            raw = float(leaf.element_size()) * float(
                np.prod(list(leaf.shape) or [1]))
            wire = float(q_np.nbytes)
            if scale is not None:
                s_np = to_numpy(scale.detach().cpu())
                arrays[key + _SCALE_SUFFIX] = s_np
                entry["scale_dtype"] = str(s_np.dtype)
                entry["nbytes"] += int(s_np.nbytes)
                wire += float(s_np.nbytes)
            raw_total += raw
            wire_total += wire
            entries.append(entry)
        return arrays, entries, {"raw": raw_total, "wire": wire_total}

    def _assign_shards(self, entries: List[Dict[str, Any]]) -> None:
        """Balance leaves over shard files by cumulative payload bytes."""
        load = [0] * self.shards
        for e in sorted(entries, key=lambda e: -e["nbytes"]):
            s = load.index(min(load))
            e["shard"] = s
            load[s] += e["nbytes"]

    @staticmethod
    def shard_file(index: int) -> str:
        return "arrays.npz" if index == 0 else f"arrays.{index}.npz"

    def _write_commit(self, step: int, arrays: Dict[str, np.ndarray],
                      meta: Dict[str, Any]) -> str:
        """Write shards + manifest into tmp.<step>, then atomically
        commit.  Runs on the writer thread when async_saves is set."""
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        by_shard: Dict[int, Dict[str, np.ndarray]] = {}
        for e in meta["keys"]:
            sh = by_shard.setdefault(e["shard"], {})
            sh[e["key"]] = arrays[e["key"]]
            if e["key"] + _SCALE_SUFFIX in arrays:
                sh[e["key"] + _SCALE_SUFFIX] = arrays[e["key"] + _SCALE_SUFFIX]
        meta["shards"] = []
        for s in range(self.shards):
            fname = self.shard_file(s)
            path = os.path.join(tmp, fname)
            np.savez(path, **by_shard.get(s, {}))
            with open(path, "rb") as f:
                blob = f.read()
            meta["shards"].append({"file": fname,
                                   "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                                   "nbytes": len(blob)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        self.stats["write_s"].append(time.perf_counter() - t0)
        log.info("checkpoint written: %s", final)
        if self.on_commit is not None:
            self.on_commit(step, final)
        return final

    def save(self, step: int, payload: Pytree) -> str:
        """Snapshot ``payload["state"]`` (+ the data stream's state
        ``payload["data"]``) at ``step``.  Returns the final directory
        (sync) or the directory the async commit will land in."""
        self.wait()
        # sweep orphaned tmp dirs a crashed previous save left behind
        for name in os.listdir(self.dir):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        t0 = time.perf_counter()
        arrays, entries, nbytes = self._encode(payload.get("state"))
        self.stats["encode_s"].append(time.perf_counter() - t0)
        meta = {"step": step, "keys": entries, "data": payload.get("data"),
                "bytes": nbytes,
                "codec": self.runtime.tier.describe()
                if self.runtime is not None else "none"}
        self._assign_shards(entries)
        final = os.path.join(self.dir, f"step_{step:08d}")
        if not self.async_saves:
            return self._write_commit(step, arrays, meta)

        def _bg():
            try:
                self._write_commit(step, arrays, meta)
            except BaseException as e:      # noqa: BLE001 — re-raised in wait
                self._async_exc = e
        self._inflight = threading.Thread(target=_bg, daemon=True,
                                          name=f"ckpt-save-{step}")
        self._inflight.start()
        return final

    def wait(self) -> None:
        """Join the in-flight async save; re-raise its failure if any."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    # ------------------------------------------------------------------
    # restore path
    def _read_manifest(self, path: str) -> Dict[str, Any]:
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise CheckpointError(f"{path}: manifest.json missing")
        try:
            with open(mpath) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointError(f"{path}: manifest.json unreadable: {e}")

    def _read_shards(self, path: str,
                     meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
        arrays: Dict[str, np.ndarray] = {}
        for sh in meta.get("shards",
                           [{"file": "arrays.npz", "crc32": None}]):
            spath = os.path.join(path, sh["file"])
            if not os.path.exists(spath):
                raise CheckpointError(f"{path}: shard {sh['file']} missing")
            with open(spath, "rb") as f:
                blob = f.read()
            if sh.get("crc32") is not None and \
                    (zlib.crc32(blob) & 0xFFFFFFFF) != sh["crc32"]:
                raise CheckpointError(
                    f"{path}: shard {sh['file']} CRC mismatch "
                    f"(corrupt or truncated)")
            try:
                with np.load(io.BytesIO(blob)) as z:
                    for k in z.files:
                        arrays[k] = z[k]
            except Exception as e:      # zipfile/format errors vary
                raise CheckpointError(
                    f"{path}: shard {sh['file']} unreadable: {e}")
        return arrays

    def restore(self, step: int) -> Tuple[int, Dict[str, Any]]:
        """Read + validate + decode the snapshot at ``step``.

        Returns ``(step, {"state": {key: tensor}, "data": ...})``: through
        a runtime the leaves come back by its tier onto its device (a
        codec's unpack kernel decodes them there); without one, in host
        memory.  Raises :class:`CheckpointError` naming the failing file
        on any missing/corrupt manifest or shard.
        """
        t0 = time.perf_counter()
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.isdir(path):
            raise CheckpointError(f"{path}: no such checkpoint")
        meta = self._read_manifest(path)
        if "keys" not in meta:
            raise CheckpointError(f"{path}: manifest has no key table")
        raw = self._read_shards(path, meta)
        flat: Dict[str, Any] = {}
        for e in meta["keys"]:
            key = e["key"]
            if key not in raw:
                raise CheckpointError(
                    f"{path}: leaf {key!r} missing from its shard")
            arr = from_numpy(raw[key], e.get("payload_dtype", e["dtype"]))
            scale = raw.get(key + _SCALE_SUFFIX)
            scale = None if scale is None else _contiguous(scale)
            dtype = torch_dtype(e["dtype"])
            if self.runtime is not None:
                if scale is not None:       # decoded beside the codes
                    scale = scale.to(self.runtime.device)
                flat[key] = self.runtime.restore_snapshot(
                    (arr, scale), TransferHints(dtype=dtype, name=key))
            elif scale is not None:
                # a codec payload restored without a tier runtime: decode
                # through the registry (the manifest names the stack)
                from repro_torch.core.compress import decode_tensor, get_codec
                codec = next((c for c in ("fp8", "int8", "blocksparse")
                              if c in meta.get("codec", "")), None)
                if codec is None:
                    raise CheckpointError(
                        f"{path}: leaf {key!r} is codec-compressed "
                        f"({meta.get('codec')}) but no codec is resolvable")
                flat[key] = decode_tensor(get_codec(codec), arr, scale,
                                          dtype)
            else:
                flat[key] = arr
        if any(t.is_cuda for t in flat.values()):
            torch.cuda.synchronize()
        self.stats["restore_s"].append(time.perf_counter() - t0)
        return meta.get("step", step), {"state": flat,
                                        "data": meta.get("data")}

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Restore the newest checkpoint that validates, skipping (with a
        warning) any step dir with a corrupt manifest or shard."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                return self.restore(step)
            except CheckpointError as e:
                log.warning("skipping corrupt checkpoint step %d: %s",
                            step, e)
        return None


# ---------------------------------------------------------------------------
def to_device(flat: Dict[str, torch.Tensor], template: Pytree,
              device) -> Pytree:
    """Rebuild the state tree of ``template`` (shapes and dtypes, e.g. on
    the meta device: :func:`~repro_torch.train.train_state.state_template`)
    from restored leaves, on ``device``.  A leaf the snapshot lacks raises
    ``KeyError`` (as the reference's), one of another shape
    ``ValueError``; a template leaf that requires a gradient gets one."""
    flat_template = _flatten(template)
    rebuilt = {}
    for key, leaf in flat_template.items():
        if leaf is None:
            rebuilt[key] = None
            continue
        if key not in flat:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        x = flat[key]
        if tuple(x.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(x.shape)}; the model's is "
                             f"{tuple(leaf.shape)}")
        x = x.to(device=device, dtype=leaf.dtype, copy=True)
        rebuilt[key] = x.requires_grad_(True) if leaf.requires_grad else x
    return _unflatten_like(template, rebuilt)


def _unflatten_like(template: Pytree, flat: Dict[str, Any]) -> Pytree:
    _, paths = tree.flatten(template)
    return tree.unflatten(paths, [flat[_SEP.join(str(k) for k in path)]
                                  for path in paths])
