"""Wire transport for KV handoffs: the cross-process leg of disaggregated
serving.

serve/disagg.py ships prefilled KV between roles through an in-process
:class:`~repro_torch.serve.disagg.TransferQueue`.  This module carries the
same handoff unit (a header plus page-shaped tensors) as length-prefixed
frames over a pluggable byte :class:`Channel`, so the prefill and decode
engines can live in different processes and still produce the token
streams the loopback pair does, bit for bit.

Wire format (schema 2; a frame this module packs is byte-identical to the
reference's for the same kind and payload bytes)::

    frame := magic "KW" | schema u16 | kind u8 | len u32 | payload | crc u32

The CRC32 covers header and payload (bulk ``K_PAGE`` frames fold
Adler-32 instead); a bad magic, a schema mismatch or a failed checksum
raises :class:`WireFormatError` before anything is unpickled.  Payloads
are pickled dicts whose tensor leaves travel as :class:`_WireLeaf`: host
numpy (bfloat16 as raw 2-byte ``V2`` records beside the dtype string
``"bfloat16"``), or a tenant codec's codes and scale.  On the card a
coded leaf is packed by the codec's kernel over its flattened 2-D view as
one row block (``core/compress.encode_tensor``) and unpacked by the
shared unpack kernel on the decode side; a handoff's leaves cross to the
host in one copy and back to the card in one.  Frames from the reference
package unpickle into this module's classes (:func:`_loads` maps the
reference's class paths), and what the decode side sends back (ACK,
RESULT, BYE) holds builtins only.

Frame kinds: ``HANDOFF`` (prefill -> decode: header + pages), ``ACK``
(decode -> prefill on adoption or discard: frees a credit of the sender's
``max_depth`` window), ``CANCEL`` (prefill -> decode: cancelled in
transit), ``RESULT`` (decode -> prefill on retire: the whole token stream
and finish reason, applied to the submitter's session), ``BYE`` (clean
shutdown); ``PAGE`` / ``ABORT`` / ``HELLO`` belong to the striped
channel.  The federation kinds keep their numbers; nothing here handles
them yet.

Metering: every frame a side sends is metered on that side's
:class:`~repro_torch.core.runtime.MemoryRuntime` as ``kv_wire`` with its
exact byte count; page payloads also meter ``kv_publish`` (raw tensor
bytes, encoded wire bytes) and ``kv_adopt`` on the decode side, so summed
over both runtimes ``kv_wire`` equals the bytes the channel carried.

Partial reads retry with exponential backoff (``backoff * 2**attempt``, no
sleep after the last attempt) and exhaust into :class:`TransportError`.
Every blocking socket call has a timeout.  Channels come from a registry:
``"memory"`` (in-process pair; ``max_chunk`` fragments reads), ``"tcp"``
(a loopback socket pair; :func:`tcp_listen` / :func:`tcp_accept` /
:func:`tcp_connect` build the two-process halves) and ``"shm"`` (tensor
bytes through a shared-memory arena, headers over the control pipe).
"""
from __future__ import annotations

import dataclasses
import io
import logging
import pickle
import queue
import select
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import MemoryPlan
from repro_torch.core.compress import decode_tensor, encode_tensor, get_codec
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.serve.disagg import KVHandoff
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.session import FINISH_CANCELLED, Session

log = logging.getLogger(__name__)

#: bump on any change to the frame layout or the HANDOFF payload schema
#: (v2: striped page frames, K_PAGE/K_ABORT/K_HELLO, federation kinds)
SCHEMA_VERSION = 2

_MAGIC = b"KW"
_HEADER = struct.Struct(">2sHBI")        # magic, schema, kind, payload len
_CRC = struct.Struct(">I")
_PAGE_SUB = struct.Struct(">II")         # meta len, out-of-band buffer count

(K_HANDOFF, K_ACK, K_CANCEL, K_RESULT, K_BYE,
 K_PAGE, K_ABORT, K_HELLO,
 K_FWD, K_FWD_RESULT, K_FWD_REJECT, K_LOAD, K_QUOTA, K_DRAIN) = range(1, 15)
_KIND_NAMES = {K_HANDOFF: "HANDOFF", K_ACK: "ACK", K_CANCEL: "CANCEL",
               K_RESULT: "RESULT", K_BYE: "BYE", K_PAGE: "PAGE",
               K_ABORT: "ABORT", K_HELLO: "HELLO", K_FWD: "FWD",
               K_FWD_RESULT: "FWD_RESULT", K_FWD_REJECT: "FWD_REJECT",
               K_LOAD: "LOAD", K_QUOTA: "QUOTA", K_DRAIN: "DRAIN"}

#: seconds a blocking socket call may wait before it fails
SOCKET_TIMEOUT = 120.0
#: seconds an in-process pair waits for a frame it sent to land, and its
#: nap between polls
SETTLE_S, SETTLE_NAP_S = 30.0, 1e-4


class TransportError(RuntimeError):
    """A channel failed mid-transfer (closed peer, exhausted retries)."""


class WireFormatError(TransportError):
    """A frame failed validation (magic/schema/CRC) — never unpickled."""


# ---------------------------------------------------------------------------
# framing
def pack_frame(kind: int, payload: bytes) -> bytes:
    head = _HEADER.pack(_MAGIC, SCHEMA_VERSION, kind, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    return head + payload + _CRC.pack(crc)


def _read_exact(channel: "Channel", n: int, *, started: bool,
                retries: int, backoff: float, sleep) -> Optional[bytes]:
    """Read exactly ``n`` bytes from ``channel``.

    Returns None when ``started`` is False and nothing at all is buffered
    (no frame on the wire: the polling case).  Once any byte of a frame
    has been read, an empty read retries with exponential backoff
    (``backoff * 2**attempt``, no sleep after the last attempt) and
    exhausts into :class:`TransportError`: a frame, once begun, must
    complete."""
    recv_into = getattr(channel, "recv_into", None)
    buf = bytearray(n) if recv_into is not None else bytearray()
    view = memoryview(buf) if recv_into is not None else None
    pos = 0
    attempt = 0
    while pos < n:
        if recv_into is not None:
            got = recv_into(view[pos:])         # straight into the buffer
            if got:
                pos += got
                attempt = 0
                continue
        else:
            chunk = channel.recv(n - pos)
            if chunk:
                buf += chunk
                pos += len(chunk)
                attempt = 0
                continue
        if pos == 0 and not started:
            return None
        if channel.closed and attempt >= retries:
            raise TransportError(
                f"channel closed mid-frame: got {pos}/{n} bytes")
        if attempt >= retries:
            raise TransportError(
                f"partial read: {pos}/{n} bytes after "
                f"{retries + 1} attempts")
        # a channel that can block on readability (TCP: select) waits in
        # the kernel instead of sleeping
        waiter = getattr(channel, "wait_readable", None)
        if waiter is not None:
            waiter(backoff * (2 ** attempt))
        else:
            sleep(backoff * (2 ** attempt))
        attempt += 1
    return buf          # bytearray: no full copy of a multi-MB frame


def recv_frame(channel: "Channel", *, retries: int = 10,
               backoff: float = 0.005, sleep=time.sleep
               ) -> Optional[Tuple[int, bytes]]:
    """Read one validated frame; None when no frame is on the wire.

    Validation order: magic, schema, then checksum.  A failure mid-frame
    (exhausted retries once a frame began, or a validation error) leaves
    the byte stream desynchronized, so the channel is *poisoned*: every
    later ``recv_frame`` on it fails fast with the first reason."""
    reason = getattr(channel, "poisoned", None)
    if reason is not None:
        raise TransportError(
            f"channel poisoned by an earlier framing failure ({reason}); "
            "the byte stream is desynchronized — reconnect required")
    try:
        head = _read_exact(channel, _HEADER.size, started=False,
                           retries=retries, backoff=backoff, sleep=sleep)
        if head is None:
            return None
        magic, schema, kind, n = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise WireFormatError(
                f"bad frame magic {magic!r} (want {_MAGIC!r}): not a KV wire "
                "frame, refusing to unpickle")
        if schema != SCHEMA_VERSION:
            raise WireFormatError(
                f"wire schema v{schema} from peer, this build speaks "
                f"v{SCHEMA_VERSION} — upgrade the older side (refusing to "
                "unpickle a mismatched layout)")
        payload = _read_exact(channel, n, started=True, retries=retries,
                              backoff=backoff, sleep=sleep)
        (crc,) = _CRC.unpack(_read_exact(channel, _CRC.size, started=True,
                                         retries=retries, backoff=backoff,
                                         sleep=sleep))
        # bulk K_PAGE frames checksum with Adler-32, the rest with CRC32
        if kind == K_PAGE:
            want = zlib.adler32(payload, zlib.adler32(head)) & 0xFFFFFFFF
        else:
            want = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
        if crc != want:
            raise WireFormatError(
                f"frame CRC mismatch (got {crc:#010x}, computed {want:#010x}): "
                "corrupted frame, refusing to unpickle")
        return kind, payload
    except (WireFormatError, TransportError) as e:
        try:
            channel.poisoned = str(e)
        except AttributeError:
            pass
        raise


# ---------------------------------------------------------------------------
# channels
class Channel:
    """One endpoint of a byte pipe.

    ``send`` writes the whole buffer or raises :class:`TransportError`;
    ``recv(n)`` returns *up to* n bytes, possibly ``b""`` when nothing is
    buffered (framing handles reassembly and retry).  ``poisoned`` is set
    by :func:`recv_frame` when a framing failure desynchronizes the byte
    stream; later reads fail fast."""

    poisoned: Optional[str] = None

    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def recv(self, n: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class _Pipe:
    """One direction of an in-memory channel pair (lock-guarded)."""

    def __init__(self, max_chunk: Optional[int] = None):
        self.buf = bytearray()
        self.max_chunk = max_chunk
        self.closed = False
        self.lock = threading.Lock()


class InMemoryChannel(Channel):
    """In-process byte pipe: the test and loopback transport.

    ``max_chunk`` bounds one ``recv`` (exercises partial-read reassembly);
    ``bytes_sent`` counts every byte pushed through ``send``: the ground
    truth of the ``kv_wire`` reconciliation."""

    def __init__(self, rx: _Pipe, tx: _Pipe):
        self._rx = rx
        self._tx = tx
        self._closed = False
        self.bytes_sent = 0

    def send(self, data: bytes) -> None:
        if self._closed:
            raise TransportError("send on closed channel")
        with self._tx.lock:
            if self._tx.closed:
                raise TransportError("peer closed the channel")
            self._tx.buf += data
        self.bytes_sent += len(data)

    def recv(self, n: int) -> bytes:
        with self._rx.lock:
            take = min(n, len(self._rx.buf))
            if self._rx.max_chunk is not None:
                take = min(take, self._rx.max_chunk)
            out = bytes(self._rx.buf[:take])
            del self._rx.buf[:take]
            return out

    def close(self) -> None:
        self._closed = True
        with self._tx.lock:
            self._tx.closed = True
        with self._rx.lock:
            self._rx.closed = True

    @property
    def closed(self) -> bool:
        return self._closed or self._rx.closed


def memory_pair(max_chunk: Optional[int] = None
                ) -> Tuple[InMemoryChannel, InMemoryChannel]:
    """A connected in-memory channel pair (a->b, b->a)."""
    ab, ba = _Pipe(max_chunk), _Pipe(max_chunk)
    return InMemoryChannel(rx=ba, tx=ab), InMemoryChannel(rx=ab, tx=ba)


class TcpChannel(Channel):
    """A connected TCP socket as a Channel (polled reads).

    ``TCP_NODELAY`` is always set (control frames must not sit behind
    Nagle); ``bufsize`` sizes ``SO_SNDBUF`` / ``SO_RCVBUF``; a send that
    cannot finish within ``SOCKET_TIMEOUT`` seconds fails."""

    def __init__(self, sock: socket.socket, *,
                 bufsize: Optional[int] = None):
        sock.settimeout(SOCKET_TIMEOUT)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if bufsize:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, int(bufsize))
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, int(bufsize))
        self.sock = sock
        self._closed = False
        self.bytes_sent = 0

    def send(self, data: bytes) -> None:
        if self._closed:
            raise TransportError("send on closed channel")
        try:
            self.sock.sendall(data)
        except OSError as e:
            self._closed = True
            raise TransportError(f"socket send failed: {e}") from e
        self.bytes_sent += len(data)

    def recv(self, n: int) -> bytes:
        if self._closed:
            return b""
        try:
            ready, _, _ = select.select([self.sock], [], [], 0)
            if not ready:
                return b""
            data = self.sock.recv(n)
        except OSError as e:
            self._closed = True
            raise TransportError(f"socket recv failed: {e}") from e
        if data == b"":
            self._closed = True      # orderly peer shutdown
        return data

    def recv_into(self, view: memoryview) -> int:
        """Read directly into ``view``; 0 when nothing is buffered."""
        if self._closed:
            return 0
        try:
            ready, _, _ = select.select([self.sock], [], [], 0)
            if not ready:
                return 0
            got = self.sock.recv_into(view)
        except OSError as e:
            self._closed = True
            raise TransportError(f"socket recv failed: {e}") from e
        if got == 0:
            self._closed = True      # readable + 0 bytes: peer shutdown
        return got

    def wait_readable(self, timeout: float) -> bool:
        """Block until data is readable (or ``timeout``)."""
        if self._closed:
            return False
        try:
            ready, _, _ = select.select([self.sock], [], [], timeout)
        except OSError:
            return False
        return bool(ready)

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


def tcp_listen(host: str = "127.0.0.1", port: int = 0, *,
               backlog: int = 1) -> Tuple[socket.socket, int]:
    """Bind a listener (port 0: ephemeral); returns (socket, bound port)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(max(1, backlog))
    return srv, srv.getsockname()[1]


def tcp_accept(listener: socket.socket, timeout: float = 60.0, *,
               bufsize: Optional[int] = None) -> TcpChannel:
    listener.settimeout(timeout)
    try:
        conn, _ = listener.accept()
    except socket.timeout as e:
        raise TransportError(f"no peer connected within {timeout}s") from e
    finally:
        listener.close()
    return TcpChannel(conn, bufsize=bufsize)


def tcp_connect(host: str, port: int, *, retries: int = 20,
                backoff: float = 0.1, sleep=time.sleep,
                bufsize: Optional[int] = None) -> TcpChannel:
    """Connect with retry (the worker may start before the listener)."""
    err: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            return TcpChannel(socket.create_connection((host, port),
                                                       timeout=30.0),
                              bufsize=bufsize)
        except OSError as e:
            err = e
            if attempt < retries:
                sleep(backoff * (2 ** min(attempt, 6)))
    raise TransportError(f"connect to {host}:{port} failed: {err}") from err


def tcp_pair(*, bufsize: Optional[int] = None
             ) -> Tuple[TcpChannel, TcpChannel]:
    """A connected loopback TCP pair in one process (real sockets)."""
    srv, port = tcp_listen()
    cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.settimeout(SOCKET_TIMEOUT)
        cli.settimeout(SOCKET_TIMEOUT)
        cli.connect(("127.0.0.1", port))
        conn, _ = srv.accept()
    except OSError as e:
        cli.close()
        raise TransportError(f"loopback TCP pair failed: {e}") from e
    finally:
        srv.close()
    return TcpChannel(conn, bufsize=bufsize), TcpChannel(cli, bufsize=bufsize)


def tcp_accept_many(listener: socket.socket, n: int,
                    timeout: float = 60.0, *,
                    bufsize: Optional[int] = None) -> List[TcpChannel]:
    """Accept ``n`` stripe connections; each announces its stripe index
    with a HELLO frame, so accept order need not match connect order."""
    listener.settimeout(timeout)
    chans: List[Optional[TcpChannel]] = [None] * n
    deadline = time.monotonic() + timeout
    try:
        for _ in range(n):
            conn, _ = listener.accept()
            ch = TcpChannel(conn, bufsize=bufsize)
            got = None
            while got is None:
                if time.monotonic() > deadline:
                    raise TransportError(
                        f"stripe HELLO did not arrive within {timeout}s")
                got = recv_frame(ch, retries=4, backoff=0.01)
                if got is None:
                    time.sleep(0.01)
            kind, payload = got
            if kind != K_HELLO:
                raise TransportError(
                    f"expected HELLO on a new stripe connection, got "
                    f"{_KIND_NAMES.get(kind, kind)}")
            hello = _loads(payload)
            if int(hello.get("streams", 0)) != n:
                raise TransportError(
                    f"stripe-count mismatch: peer connected with "
                    f"{hello.get('streams')} streams, this side expects {n}")
            idx = int(hello["stripe"])
            if not 0 <= idx < n or chans[idx] is not None:
                raise TransportError(f"bad or duplicate stripe index {idx}")
            chans[idx] = ch
    except socket.timeout as e:
        raise TransportError(
            f"{sum(c is not None for c in chans)}/{n} stripes connected "
            f"within {timeout}s") from e
    finally:
        listener.close()
    return [c for c in chans if c is not None]


def tcp_accept_striped(listener: socket.socket, streams: int,
                       timeout: float = 60.0, *,
                       bufsize: Optional[int] = None) -> "StripedChannel":
    return StripedChannel(tcp_accept_many(listener, streams, timeout,
                                          bufsize=bufsize))


def tcp_connect_striped(host: str, port: int, streams: int, *,
                        retries: int = 20, backoff: float = 0.1,
                        sleep=time.sleep,
                        bufsize: Optional[int] = None) -> "StripedChannel":
    """Open ``streams`` connections to one listener, announcing each
    stripe index with a HELLO frame."""
    chans: List[TcpChannel] = []
    for i in range(streams):
        ch = tcp_connect(host, port, retries=retries, backoff=backoff,
                         sleep=sleep, bufsize=bufsize)
        ch.send(pack_frame(K_HELLO, pickle.dumps(
            {"stripe": i, "streams": streams}, pickle.HIGHEST_PROTOCOL)))
        chans.append(ch)
    return StripedChannel(chans)


# ---------------------------------------------------------------------------
# transport registry (mirrors the scheduler/codec registries)
_TRANSPORTS: Dict[str, Callable[..., Tuple[Channel, Channel]]] = {}


def register_transport(name: str,
                       factory: Callable[..., Tuple[Channel, Channel]]
                       ) -> None:
    _TRANSPORTS[name] = factory


def build_transport(name: str, **kwargs) -> Tuple[Channel, Channel]:
    """Build a connected channel pair (prefill end, decode end)."""
    if name not in _TRANSPORTS:
        raise KeyError(f"unknown transport {name!r}; "
                       f"registered: {registered_transports()}")
    return _TRANSPORTS[name](**kwargs)


def registered_transports() -> Tuple[str, ...]:
    return tuple(sorted(_TRANSPORTS))


register_transport("memory", memory_pair)
register_transport("tcp", tcp_pair)


# ---------------------------------------------------------------------------
# leaf/tree serialization (optionally through a tenant codec)
@dataclasses.dataclass
class _WireLeaf:
    """One tensor leaf in wire form: raw numpy, or codec (q, scale).

    ``dtype`` names the leaf's own dtype ("float32", "bfloat16"); a dtype
    numpy lacks (bfloat16, float8) travels as raw ``V<itemsize>``
    records.  The field names are the reference's, so each package's
    pickles load into the other's class."""

    data: np.ndarray
    scale: Optional[np.ndarray]
    dtype: str
    codec: Optional[str]

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + (self.scale.nbytes
                                   if self.scale is not None else 0)


def _is_wire_leaf(x) -> bool:
    return isinstance(x, _WireLeaf)


#: the reference package's classes a received frame may name, and this
#: module's classes that take their place (a table of names: nothing of
#: the reference is imported)
_ALIASES = {("repro.serve.transport", "_WireLeaf"): "_WireLeaf",
            ("repro.serve.transport", "_ShmLeaf"): "_ShmLeaf"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        own = _ALIASES.get((module, name))
        if own is not None:
            return globals()[own]
        return super().find_class(module, name)


def _loads(payload, buffers=None) -> Any:
    """``pickle.loads`` that maps the reference's wire classes to ours."""
    return _Unpickler(io.BytesIO(payload), buffers=buffers).load()


_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
              torch.float16: np.float16, torch.int64: np.int64,
              torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8,
              torch.bool: np.bool_}
#: a codec's code dtype where numpy has none (codes then cross as V1)
_CODE_DTYPES = {"fp8": torch.float8_e4m3fn}
_ALIGN = 16


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise WireFormatError(f"unknown leaf dtype {name!r} on the wire")
    return dt


def _offsets(sizes: Sequence[int]) -> Tuple[List[int], int]:
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += (n + _ALIGN - 1) // _ALIGN * _ALIGN
    return offs, total


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of ``tensors``: one staging buffer (pinned when
    they lie on the card) filled by one copy a tensor and read after one
    synchronization."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    offs, total = _offsets([f.numel() for f in flat])
    cuda = tensors[0].is_cuda
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=cuda)
    for f, off in zip(flat, offs):
        host[off:off + f.numel()].copy_(f, non_blocking=cuda)
    if cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    raw = host.numpy()
    out = []
    for t, f, off in zip(tensors, flat, offs):
        np_dt = _NP_DTYPES.get(t.dtype) or np.dtype(f"V{t.element_size()}")
        out.append(raw[off:off + f.numel()].view(np_dt).reshape(t.shape))
    return out


def _to_device(arrays: Sequence[np.ndarray], dtypes: Sequence[torch.dtype],
               device: torch.device) -> List[torch.Tensor]:
    """``arrays`` as tensors of ``dtypes`` on ``device``: one staging
    buffer (pinned for the card) and one copy to the device."""
    if not arrays:
        return []
    flat = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            for a in arrays]
    offs, total = _offsets([f.size for f in flat])
    cuda = device.type == "cuda"
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=cuda)
    raw = host.numpy()
    for f, off in zip(flat, offs):
        raw[off:off + f.size] = f
    buf = host.to(device, non_blocking=cuda)
    out = []
    for a, f, off, dt in zip(arrays, flat, offs, dtypes):
        out.append(buf[off:off + f.size].view(dt).reshape(a.shape))
    return out


def _encode_trees(trees: Sequence[Any], codec: Optional[str]
                  ) -> Tuple[List[Any], float, float, int]:
    """Wire form of every tree in ``trees`` (a handoff's pages and slot
    leaves): a float leaf goes through ``codec`` (its pack kernel on the
    card) when one is named; all leaves then cross to the host in one
    copy.  Returns (wired trees, raw tensor bytes, encoded wire bytes,
    leaf count)."""
    c = get_codec(codec) if codec is not None else None
    flat = [tree.flatten(t) for t in trees]
    parts: List[Tuple[torch.Tensor, Optional[torch.Tensor], str]] = []
    raw = 0.0
    for leaves, _ in flat:
        for x in leaves:
            raw += float(x.numel() or 1) * x.element_size()
            if c is not None and x.is_floating_point():
                q, scale = encode_tensor(c, x)
                parts.append((q, scale, _dtype_name(x.dtype)))
            else:
                parts.append((x, None, _dtype_name(x.dtype)))
    tensors = [t for q, s, _ in parts for t in ((q,) if s is None
                                                 else (q, s))]
    host = iter(_to_host(tensors))
    wired, wire, k = [], 0.0, 0
    for leaves, paths in flat:
        out = []
        for _ in leaves:
            q, scale, dtype = parts[k]
            k += 1
            leaf = _WireLeaf(next(host),
                             next(host) if scale is not None else None,
                             dtype, codec if scale is not None else None)
            wire += leaf.nbytes
            out.append(leaf)
        wired.append(tree.unflatten(paths, out))
    return wired, raw, wire, len(parts)


def _decode_trees(trees: Sequence[Any], device: torch.device) -> List[Any]:
    """Inverse of :func:`_encode_trees` onto ``device``: every leaf's bytes
    cross in one copy; a coded leaf is unpacked by its codec (the unpack
    kernel on the card) into the leaf's dtype."""
    flat = [tree.flatten(t) for t in trees]
    arrays, dtypes = [], []
    for leaves, _ in flat:
        for j, leaf in enumerate(leaves):
            data = leaf.data
            if leaf.codec is None:
                dt = _torch_dtype(leaf.dtype)
            elif data.dtype.kind == "V":
                dt = _CODE_DTYPES[leaf.codec]
            else:
                dt = torch.from_numpy(data[:0]).dtype
            arrays.append(data)
            dtypes.append(dt)
            if leaf.scale is not None:
                arrays.append(np.asarray(leaves[j].scale, np.float32))
                dtypes.append(torch.float32)
    moved = iter(_to_device(arrays, dtypes, device))
    out = []
    for leaves, paths in flat:
        vals = []
        for leaf in leaves:
            x = next(moved)
            if leaf.codec is not None:
                scale = next(moved) if leaf.scale is not None else None
                x = decode_tensor(get_codec(leaf.codec), x, scale,
                                  dtype=_torch_dtype(leaf.dtype))
            vals.append(x)
        out.append(tree.unflatten(paths, vals))
    return out


def _adopt_bytes(trees: Sequence[Any]) -> Tuple[float, float, int]:
    """(raw tensor bytes, wire bytes, leaf count) of wired trees, as the
    decode side meters ``kv_adopt``."""
    raw = wire = 0.0
    calls = 0
    for t in trees:
        for leaf in tree.leaves(t):
            if leaf.codec:
                raw += float(np.prod(leaf.data.shape) or 1) * \
                    _torch_dtype(leaf.dtype).itemsize
            else:
                raw += float(leaf.data.nbytes)
            wire += leaf.nbytes
            calls += 1
    return raw, wire, calls


# ---------------------------------------------------------------------------
# message-level channels: striped multi-stream and shared memory speak
# whole messages (``send_msg`` / ``send_handoff`` / ``poll_msg``);
# WireSender / WireReceiver detect that surface through the helpers below
# and skip their own framing.
def _send_msg(channel, kind: int, msg: Any) -> int:
    """Send one message; returns the exact bytes that hit the wire."""
    if hasattr(channel, "send_msg"):
        return channel.send_msg(kind, msg)
    frame = pack_frame(kind, pickle.dumps(msg, pickle.HIGHEST_PROTOCOL))
    channel.send(frame)
    return len(frame)


def _send_handoff_msg(channel, msg: Dict[str, Any],
                      wired_pages: List[Any]) -> int:
    """Send one HANDOFF (header ``msg`` without pages + the wired page
    trees); a single-stream channel carries the pages inline in the
    header frame."""
    if hasattr(channel, "send_handoff"):
        return channel.send_handoff(msg, wired_pages)
    whole = dict(msg)
    whole["pages"] = wired_pages
    return _send_msg(channel, K_HANDOFF, whole)


def _poll_msg(channel, *, retries: int = 10, backoff: float = 0.005,
              sleep=time.sleep) -> Optional[Tuple[int, Any]]:
    """Receive one whole message; None when nothing is deliverable."""
    if hasattr(channel, "poll_msg"):
        return channel.poll_msg()
    got = recv_frame(channel, retries=retries, backoff=backoff, sleep=sleep)
    if got is None:
        return None
    kind, payload = got
    return kind, _loads(payload)


def _send_page_frame(channel: Channel, msg: Dict[str, Any]) -> int:
    """Send one K_PAGE frame with pickle-5 out-of-band buffers.

    Payload layout: ``meta_len u32 | nbufs u32 | nbufs x len u64 | meta
    (pickle) | buffers``.  The page's tensor bytes go to the channel as
    raw buffer views (no intermediate pickle copy), and the Adler-32
    checksum folds over each segment."""
    bufs: List[memoryview] = []
    meta = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL,
                        buffer_callback=lambda b: bufs.append(b.raw()))
    sizes = [b.nbytes for b in bufs]
    sub = _PAGE_SUB.pack(len(meta), len(bufs)) + \
        struct.pack(f">{len(bufs)}Q", *sizes)
    total = len(sub) + len(meta) + sum(sizes)
    head = _HEADER.pack(_MAGIC, SCHEMA_VERSION, K_PAGE, total)
    crc = zlib.adler32(meta, zlib.adler32(sub, zlib.adler32(head)))
    for mv in bufs:
        crc = zlib.adler32(mv, crc)
    channel.send(head + sub + meta)
    for mv in bufs:
        channel.send(mv)
    channel.send(_CRC.pack(crc & 0xFFFFFFFF))
    return _HEADER.size + total + _CRC.size


def _unpack_page_payload(payload: bytes) -> Dict[str, Any]:
    meta_len, nbufs = _PAGE_SUB.unpack_from(payload, 0)
    off = _PAGE_SUB.size
    sizes = struct.unpack_from(f">{nbufs}Q", payload, off)
    off += 8 * nbufs
    view = memoryview(payload)
    meta = view[off:off + meta_len]
    off += meta_len
    bufs = []
    for s in sizes:
        bufs.append(view[off:off + s])
        off += s
    return _loads(meta, buffers=bufs)


class _SendBatch:
    """Completion barrier for one multi-frame send across stripes."""

    def __init__(self, n: int):
        self._cv = threading.Condition()
        self._left = n
        self.bytes = 0
        self.errors: List[BaseException] = []

    def done(self, nbytes: int, err: Optional[BaseException] = None) -> None:
        with self._cv:
            if err is None:
                self.bytes += nbytes
            else:
                self.errors.append(err)
            self._left -= 1
            if self._left <= 0:
                self._cv.notify_all()

    def wait(self, timeout: float = 300.0) -> None:
        with self._cv:
            if not self._cv.wait_for(lambda: self._left <= 0, timeout):
                self.errors.append(TransportError(
                    f"stripe send stalled for {timeout}s"))


class _StripeTx(threading.Thread):
    """Per-stripe send worker: pickles, frames, checksums and writes its
    stripe (host bytes only)."""

    def __init__(self, index: int, channel: Channel):
        super().__init__(name=f"kv-wire-tx{index}", daemon=True)
        self.channel = channel
        self.jobs: "queue.Queue" = queue.Queue()
        self.start()

    def run(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            kind, msg, batch = job
            try:
                if kind == K_PAGE:
                    batch.done(_send_page_frame(self.channel, msg))
                else:
                    frame = pack_frame(
                        kind, pickle.dumps(msg, pickle.HIGHEST_PROTOCOL))
                    self.channel.send(frame)
                    batch.done(len(frame))
            except Exception as e:                # surfaced via the batch
                batch.done(0, err=e)

    def stop(self) -> None:
        self.jobs.put(None)


class _StripeRx(threading.Thread):
    """Per-stripe receive worker: reads, validates and unpickles frames
    into the shared inbox, so checksum and decode run per stripe."""

    def __init__(self, index: int, channel: Channel, inbox, cond, *,
                 retries: int, backoff: float, poll_sleep: float):
        super().__init__(name=f"kv-wire-rx{index}", daemon=True)
        self.index = index
        self.channel = channel
        self.inbox = inbox
        self.cond = cond
        self.retries, self.backoff = retries, backoff
        self.poll_sleep = poll_sleep
        self.failed: Optional[Exception] = None
        self._halt = False
        self.start()

    def run(self) -> None:
        while not self._halt:
            try:
                got = recv_frame(self.channel, retries=self.retries,
                                 backoff=self.backoff)
                if got is None:
                    if self.channel.closed:
                        return
                    waiter = getattr(self.channel, "wait_readable", None)
                    if waiter is not None:
                        waiter(self.poll_sleep)
                    else:
                        time.sleep(self.poll_sleep)
                    continue
                kind, payload = got
                msg = (_unpack_page_payload(payload) if kind == K_PAGE
                       else _loads(payload))
            except Exception as e:                # surfaced by poll_msg
                self.failed = e
                with self.cond:
                    self.cond.notify_all()
                return
            with self.cond:
                self.inbox.append((self.index, kind, msg))
                self.cond.notify_all()

    def halt(self) -> None:
        self._halt = True


class StripedChannel:
    """Frame fan-out over N byte sub-channels.

    Each HANDOFF shards page-wise: the header rides stripe 0, the FIFO
    every control frame (ACK / CANCEL / RESULT / BYE) uses, and page
    ``seq`` goes to stripe ``seq % N`` as a K_PAGE frame tagged ``(msg_id,
    seq)``.  The receive side reassembles by sequence number and delivers
    messages in stripe-0 arrival order, so the striped wire delivers what
    the single-stream one does.  Per-stripe worker threads carry the
    pickle and checksum work on host bytes.

    A stripe dying mid-handoff raises :class:`TransportError` from
    ``send_handoff`` (the engine requeues the session; ``err.wire_bytes``
    holds what did reach the wire) and a best-effort ABORT on stripe 0
    tells the peer to drop the partial reassembly; if stripe 0 itself is
    dead, or a stripe's receive fails, the channel poisons."""

    def __init__(self, channels: Sequence[Channel], *, retries: int = 10,
                 backoff: float = 0.005, poll_sleep: float = 0.002):
        if not channels:
            raise ValueError("need at least one stripe channel")
        self.stripes = list(channels)
        self.poisoned: Optional[str] = None
        self._closed = False
        self._send_id = 0
        self._cond = threading.Condition()
        self._inbox: Deque[Tuple[int, int, Any]] = deque()
        self._ordered: Deque[Tuple[int, Any]] = deque()
        self._partial: Dict[int, Dict[int, Any]] = {}   # msg_id -> seq->page
        self._aborted: set = set()
        self._tx = [_StripeTx(i, ch) for i, ch in enumerate(self.stripes)]
        self._rx = [_StripeRx(i, ch, self._inbox, self._cond,
                              retries=retries, backoff=backoff,
                              poll_sleep=poll_sleep)
                    for i, ch in enumerate(self.stripes)]

    # ------------------------------------------------------------------
    @property
    def streams(self) -> int:
        return len(self.stripes)

    @property
    def bytes_sent(self) -> int:
        return sum(getattr(ch, "bytes_sent", 0) for ch in self.stripes)

    @property
    def closed(self) -> bool:
        return self._closed or any(ch.closed for ch in self.stripes)

    def _fail_fast(self) -> None:
        if self.poisoned is not None:
            raise TransportError(
                f"striped channel poisoned: {self.poisoned}")
        for rx in self._rx:
            if rx.failed is not None:
                self.poisoned = (f"stripe {rx.index} receive failed: "
                                 f"{rx.failed}")
                raise TransportError(self.poisoned) from rx.failed

    # ------------------------------------------------------------------
    def send_msg(self, kind: int, msg: Any) -> int:
        self._fail_fast()
        batch = _SendBatch(1)
        self._tx[0].jobs.put((kind, msg, batch))
        batch.wait()
        if batch.errors:
            err = TransportError(f"stripe 0 send failed: {batch.errors[0]}")
            err.wire_bytes = batch.bytes
            raise err from batch.errors[0]
        return batch.bytes

    def send_handoff(self, msg: Dict[str, Any],
                     wired_pages: List[Any]) -> int:
        self._fail_fast()
        self._send_id += 1
        mid = self._send_id
        header = dict(msg)
        header["pages"] = []
        header["striped"] = {"msg_id": mid, "n_pages": len(wired_pages)}
        batch = _SendBatch(1 + len(wired_pages))
        self._tx[0].jobs.put((K_HANDOFF, header, batch))
        for seq, page in enumerate(wired_pages):
            self._tx[seq % len(self._tx)].jobs.put(
                (K_PAGE, {"msg_id": mid, "seq": seq, "page": page}, batch))
        batch.wait()
        if batch.errors:
            sent = batch.bytes
            ab = _SendBatch(1)
            self._tx[0].jobs.put((K_ABORT, {"msg_id": mid}, ab))
            ab.wait(timeout=10.0)
            if ab.errors:
                self.poisoned = (f"stripe 0 dead while aborting a partial "
                                 f"handoff: {ab.errors[0]}")
            else:
                sent += ab.bytes
            err = TransportError(
                f"striped handoff failed mid-send: {batch.errors[0]}")
            err.wire_bytes = sent
            raise err from batch.errors[0]
        return batch.bytes

    # ------------------------------------------------------------------
    def poll_msg(self) -> Optional[Tuple[int, Any]]:
        self._fail_fast()
        with self._cond:
            items = list(self._inbox)
            self._inbox.clear()
        for _idx, kind, msg in items:
            if kind == K_PAGE:
                mid = msg["msg_id"]
                if mid in self._aborted:
                    continue
                self._partial.setdefault(mid, {})[msg["seq"]] = msg["page"]
            else:
                self._ordered.append((kind, msg))
        while self._ordered:
            kind, msg = self._ordered[0]
            if kind == K_ABORT:
                self._ordered.popleft()
                self._drop(msg["msg_id"])
                continue
            meta = msg.get("striped") if kind == K_HANDOFF else None
            if meta is not None:
                mid, n = meta["msg_id"], meta["n_pages"]
                got = self._partial.get(mid, {})
                if len(got) < n:
                    if self._pending_abort(mid):
                        self._ordered.popleft()
                        self._drop(mid)
                        continue
                    return None       # wait for the rest of the pages
                self._ordered.popleft()
                self._partial.pop(mid, None)
                msg = dict(msg)
                msg["pages"] = [got[i] for i in range(n)]
                del msg["striped"]
                return kind, msg
            self._ordered.popleft()
            return kind, msg
        return None

    def _pending_abort(self, mid: int) -> bool:
        found = next((item for item in self._ordered
                      if item[0] == K_ABORT and item[1]["msg_id"] == mid),
                     None)
        if found is None:
            return False
        self._ordered.remove(found)
        return True

    def _drop(self, mid: int) -> None:
        self._partial.pop(mid, None)
        self._aborted.add(mid)

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        for tx in self._tx:
            tx.stop()
        for rx in self._rx:
            rx.halt()
        for ch in self.stripes:
            ch.close()
        for t in (*self._tx, *self._rx):
            t.join(timeout=5.0)

    def describe(self) -> str:
        return f"striped[{len(self.stripes)} stripes]"


def striped_pair(streams: int, *, base: str = "memory",
                 max_chunk: Optional[int] = None,
                 bufsize: Optional[int] = None
                 ) -> Tuple[StripedChannel, StripedChannel]:
    """A connected striped pair over ``streams`` sub-channel pairs."""
    pairs = []
    for _ in range(streams):
        if base == "memory":
            pairs.append(memory_pair(max_chunk))
        elif base == "tcp":
            pairs.append(tcp_pair(bufsize=bufsize))
        else:
            pairs.append(build_transport(base))
    return (StripedChannel([p[0] for p in pairs]),
            StripedChannel([p[1] for p in pairs]))


# ---------------------------------------------------------------------------
# same-host path: payload leaves land in a shared-memory arena
DEFAULT_ARENA_BYTES = 64 << 20


class ShmArena:
    """A shared-memory block with a first-fit free-list allocator.

    The *sender* owns the arena: it creates the segment, allocates and
    writes payload blocks, and frees a handoff's blocks when the ACK for
    that handoff arrives (adoption and discard both ACK, so a cancel in
    transit cannot leak arena space).  The receiver attaches by name and
    only reads.  ``close`` unlinks the segment on the owner's side."""

    def __init__(self, nbytes: Optional[int] = None, *,
                 name: Optional[str] = None):
        from multiprocessing import shared_memory
        if name is None:
            self.shm = shared_memory.SharedMemory(create=True,
                                                  size=int(nbytes))
            self.owner = True
        else:
            # the creator owns cleanup; suppress the attach-side
            # resource_tracker registration so unlink happens once
            from multiprocessing import resource_tracker
            orig_register = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
            try:
                self.shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig_register
            self.owner = False
        self.size = self.shm.size
        self._lock = threading.Lock()
        self._free: List[Tuple[int, int]] = [(0, self.size)]

    @property
    def name(self) -> str:
        return self.shm.name

    @staticmethod
    def _align(n: int) -> int:
        return (int(n) + 63) & ~63

    def alloc(self, nbytes: int) -> Optional[int]:
        n = self._align(nbytes)
        with self._lock:
            for i, (off, sz) in enumerate(self._free):
                if sz >= n:
                    if sz == n:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + n, sz - n)
                    return off
        return None

    def free(self, offset: int, nbytes: int) -> None:
        n = self._align(nbytes)
        with self._lock:
            self._free.append((offset, n))
            self._free.sort()
            merged: List[List[int]] = []
            for off, sz in self._free:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1][1] += sz
                else:
                    merged.append([off, sz])
            self._free = [(off, sz) for off, sz in merged]

    def write(self, offset: int, arr: np.ndarray) -> None:
        flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        dst = np.frombuffer(self.shm.buf, np.uint8, count=flat.nbytes,
                            offset=offset)
        np.copyto(dst, flat)

    def read(self, offset: int, nbytes: int, dtype: str,
             shape: Tuple[int, ...]) -> np.ndarray:
        src = np.frombuffer(self.shm.buf, np.uint8, count=int(nbytes),
                            offset=offset)
        return src.copy().view(np.dtype(dtype)).reshape(shape)

    def free_bytes(self) -> int:
        with self._lock:
            return sum(sz for _, sz in self._free)

    def close(self) -> None:
        try:
            self.shm.close()
            if self.owner:
                self.shm.unlink()
        except Exception:      # noqa: BLE001 — best-effort release
            pass


@dataclasses.dataclass
class _ShmLeaf:
    """One tensor leaf parked in the arena: only this descriptor (plus the
    small codec scale) crosses the control channel."""

    offset: int
    nbytes: int
    shape: Tuple[int, ...]
    data_dtype: str
    scale: Optional[np.ndarray]
    dtype: str
    codec: Optional[str]


class ShmChannel:
    """Same-host transport endpoint (message-level).

    HANDOFF page leaves are copied into a shared-memory arena; only the
    header and arena offsets cross the control channel, so ``kv_wire``
    meters header bytes while ``kv_publish`` / ``kv_adopt`` still
    reconcile the tensor bytes.  The receiver attaches the arena by name
    from the first header (across processes on one host) and copies
    leaves out at delivery; the sender frees a handoff's blocks when its
    ACK comes back.  If the arena is full, leaves ship inline in the
    header (counted in ``arena_spills``)."""

    def __init__(self, control: Channel, *,
                 arena_bytes: int = DEFAULT_ARENA_BYTES,
                 retries: int = 10, backoff: float = 0.005,
                 sleep=time.sleep):
        self.control = control
        self.arena_bytes = int(arena_bytes)
        self._arena: Optional[ShmArena] = None        # lazily on first send
        self._peer_arena: Optional[ShmArena] = None   # attached on recv
        self._allocs: Dict[int, List[Tuple[int, int]]] = {}  # uid -> blocks
        self._retries, self._backoff, self._sleep = retries, backoff, sleep
        self.arena_spills = 0

    # ------------------------------------------------------------------
    @property
    def poisoned(self) -> Optional[str]:
        return getattr(self.control, "poisoned", None)

    @property
    def bytes_sent(self) -> int:
        return getattr(self.control, "bytes_sent", 0)

    @property
    def closed(self) -> bool:
        return self.control.closed

    @property
    def arena(self) -> Optional[ShmArena]:
        return self._arena

    # ------------------------------------------------------------------
    def send_msg(self, kind: int, msg: Any) -> int:
        frame = pack_frame(kind, pickle.dumps(msg, pickle.HIGHEST_PROTOCOL))
        self.control.send(frame)
        return len(frame)

    def send_handoff(self, msg: Dict[str, Any],
                     wired_pages: List[Any]) -> int:
        if self._arena is None:
            need = sum(leaf.data.nbytes for page in wired_pages
                       for leaf in tree.leaves(page))
            self._arena = ShmArena(max(self.arena_bytes, 2 * int(need)))
        arena = self._arena
        blocks: List[Tuple[int, int]] = []

        def stash(leaf: _WireLeaf):
            data = np.ascontiguousarray(leaf.data)
            off = arena.alloc(data.nbytes)
            if off is None:
                self.arena_spills += 1
                return leaf              # arena full: ship inline
            arena.write(off, data)
            blocks.append((off, data.nbytes))
            return _ShmLeaf(off, data.nbytes, tuple(data.shape),
                            str(data.dtype), leaf.scale, leaf.dtype,
                            leaf.codec)

        shipped = [tree.map(stash, page) for page in wired_pages]
        out = dict(msg)
        out["pages"] = shipped
        out["arena"] = {"name": arena.name, "size": arena.size}
        try:
            nbytes = self.send_msg(K_HANDOFF, out)
        except TransportError:
            for off, sz in blocks:
                arena.free(off, sz)
            raise
        if blocks:
            self._allocs.setdefault(int(msg["uid"]), []).extend(blocks)
        return nbytes

    # ------------------------------------------------------------------
    def poll_msg(self) -> Optional[Tuple[int, Any]]:
        got = recv_frame(self.control, retries=self._retries,
                         backoff=self._backoff, sleep=self._sleep)
        if got is None:
            return None
        kind, payload = got
        msg = _loads(payload)
        if kind == K_ACK:
            self._free_uid(msg.get("uid"))
        elif kind == K_HANDOFF and "arena" in msg:
            if self._peer_arena is None:
                self._peer_arena = ShmArena(name=msg["arena"]["name"])
            msg = dict(msg)
            msg.pop("arena")
            msg["pages"] = [self._inflate(t) for t in msg["pages"]]
        return kind, msg

    def _inflate(self, page):
        def load(leaf):
            if isinstance(leaf, _WireLeaf):      # inline (arena-full) leaf
                return leaf
            data = self._peer_arena.read(leaf.offset, leaf.nbytes,
                                         leaf.data_dtype, leaf.shape)
            return _WireLeaf(data, leaf.scale, leaf.dtype, leaf.codec)

        return tree.map(load, page)

    def _free_uid(self, uid) -> None:
        for off, sz in self._allocs.pop(uid, []):
            self._arena.free(off, sz)

    # ------------------------------------------------------------------
    def close(self) -> None:
        self.control.close()
        for arena in (self._peer_arena, self._arena):
            if arena is not None:
                arena.close()
        self._peer_arena = self._arena = None

    def describe(self) -> str:
        size = self._arena.size if self._arena else 0
        return f"shm[arena={size >> 20}MB spills={self.arena_spills}]"


def shm_pair(*, arena_bytes: int = DEFAULT_ARENA_BYTES,
             max_chunk: Optional[int] = None
             ) -> Tuple[ShmChannel, ShmChannel]:
    """A connected same-host pair: in-memory control pipe + shm arena."""
    a, b = memory_pair(max_chunk)
    return (ShmChannel(a, arena_bytes=arena_bytes),
            ShmChannel(b, arena_bytes=arena_bytes))


register_transport("shm", shm_pair)


def probe_wire(*, transport: str = "memory", streams: int = 1,
               payload_mb: float = 64.0, pages: int = 64,
               codec: Optional[str] = None, repeats: int = 3,
               bufsize: Optional[int] = None,
               max_chunk: Optional[int] = None,
               device="cuda") -> Dict[str, float]:
    """Measure raw handoff throughput of one wire configuration.

    Ships a synthetic multi-page HANDOFF (``payload_mb`` of float32 KV
    split over ``pages`` page trees from ``np.random.default_rng(0)``,
    placed on ``device`` where the engine keeps its pages, optionally
    codec-encoded there: the codec's pack kernel on the card) through a
    freshly built channel pair and times send to full reassembly on the
    host clock; a drain thread plays the decode side so blocking
    transports (TCP) make progress.  Returns the best of ``repeats`` as
    ``mb_per_s`` / ``handoff_ms`` plus the exact ``wire_bytes`` one
    handoff costs."""
    if streams > 1:
        tx, rx = striped_pair(streams, base=transport, bufsize=bufsize,
                              max_chunk=max_chunk)
    elif transport == "shm":
        tx, rx = shm_pair(max_chunk=max_chunk)
    elif transport == "tcp":
        tx, rx = tcp_pair(bufsize=bufsize)
    else:
        tx, rx = memory_pair(max_chunk)

    per_page = int(payload_mb * (1 << 20)) // (pages * 8)  # f32 k+v leaves
    rng = np.random.default_rng(0)
    raw_pages = [{"k": rng.standard_normal(per_page).astype(np.float32),
                  "v": rng.standard_normal(per_page).astype(np.float32)}
                 for _ in range(pages)]
    dev = torch.device(device)
    wired = _encode_trees([tree.map(lambda a: torch.from_numpy(a).to(dev),
                                    p) for p in raw_pages], codec)[0]

    done = threading.Event()
    state: Dict[str, Any] = {}

    def drain(expect_uid: int) -> None:
        while True:
            got = _poll_msg(rx, retries=50, backoff=0.001)
            if got is None:
                time.sleep(0.0005)
                continue
            kind, msg = got
            if kind == K_HANDOFF and msg["uid"] == expect_uid:
                state["t_end"] = time.perf_counter()
                state["n_pages"] = len(msg["pages"])
                _send_msg(rx, K_ACK, {"uid": expect_uid})
                done.set()
                return

    best = float("inf")
    sent_bytes = 0
    try:
        for rep in range(repeats):
            done.clear()
            t = threading.Thread(target=drain, args=(rep,), daemon=True)
            t.start()
            msg = {"schema": SCHEMA_VERSION, "uid": rep, "pages": [],
                   "slot_one": None}
            t0 = time.perf_counter()
            sent_bytes = _send_handoff_msg(tx, msg, wired)
            if not done.wait(timeout=300.0):
                raise TransportError("wire probe stalled")
            best = min(best, state["t_end"] - t0)
            if state["n_pages"] != pages:
                raise TransportError(f"wire probe: {state['n_pages']} of "
                                     f"{pages} pages reassembled")
            while _poll_msg(tx) is None:     # the ACK (frees shm blocks)
                time.sleep(0.0005)
            t.join(timeout=10.0)
    finally:
        tx.close()
        rx.close()
    return {"transport": transport, "streams": float(streams),
            "payload_mb": payload_mb,
            "mb_per_s": payload_mb / best,
            "handoff_ms": best * 1e3,
            "wire_bytes": float(sent_bytes)}


# ---------------------------------------------------------------------------
class WireHandoff:
    """Decode-side view of one in-flight session, rebuilt off the wire.
    Duck-types the :class:`~repro_torch.serve.disagg.KVHandoff` surface the
    decode engine and ``PagedKVCacheManager.adopt`` read."""

    def __init__(self, session: Session, length: int, pages: List[Any],
                 slot_one: Any, requeues: int = 0):
        self.session = session
        self.length = length
        self.pages = pages               # wired trees, decoded at fetch
        self.slot_one = slot_one
        self.requeues = requeues

    @property
    def uid(self) -> int:
        return self.session.uid

    @property
    def num_pages(self) -> int:
        return len(self.pages)


def _control(channel: Channel, runtime: MemoryRuntime, kind: int,
             msg: Dict[str, Any]) -> None:
    nbytes = _send_msg(channel, kind, msg)
    runtime.meter_transfer("kv_wire", nbytes, nbytes)


class _WireEnd:
    """Message counts of one end of the wire: ``sent_msgs`` messages sent
    whole, ``taken_msgs`` messages taken off the channel (what
    :meth:`WirePair.step` settles on)."""
    channel: Channel
    runtime: MemoryRuntime
    sent_msgs = 0
    taken_msgs = 0

    def _control(self, kind: int, msg: Dict[str, Any]) -> None:
        _control(self.channel, self.runtime, kind, msg)
        self.sent_msgs += 1


class WireSender(_WireEnd):
    """Prefill-side half of the wire: duck-types the ``TransferQueue``
    surface the prefill-role Engine drives (``has_room`` / ``publish`` /
    ``depth`` / ``sweep_cancelled`` / ``traffic_report``).

    ``max_depth`` is a *credit window*: a published handoff holds a credit
    until the decode side ACKs its adoption (or discard), so queue
    pressure backs up into the prefill scheduler as in the loopback.
    ``codec_for`` (tenant -> codec name, e.g. ``QuotaManager.codec_for``)
    sends float page leaves through the tenant's codec."""

    def __init__(self, channel: Channel, runtime: MemoryRuntime, *,
                 max_depth: Optional[int] = None,
                 codec_for: Optional[Callable[[str],
                                              Optional[str]]] = None,
                 quota: Optional[QuotaManager] = None,
                 retries: int = 10, backoff: float = 0.005,
                 sleep=time.sleep):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1: {max_depth}")
        self.channel = channel
        self.runtime = runtime
        self.max_depth = max_depth
        self.codec_for = codec_for
        self.quota = quota
        self._retries, self._backoff, self._sleep = retries, backoff, sleep
        self._inflight: Dict[int, Session] = {}   # published, not adopted
        self._adopted: Dict[int, Session] = {}    # ACKed, awaiting RESULT
        self.completed: List[Session] = []        # RESULT applied
        self.peer_done = False
        # counters named like TransferQueue's
        self.published = 0
        self.delivered = 0          # ACKs applied (adopted by the peer)
        self.requeued = 0
        self.swept = 0
        self.results = 0
        self.shipped_pages = 0

    # ------------------------------------------------------------------
    def depth(self) -> int:
        self.pump()
        return len(self._inflight)

    def outstanding(self) -> int:
        """Sessions the peer still owes a RESULT for."""
        return len(self._inflight) + len(self._adopted)

    def has_room(self, pending: int = 0) -> bool:
        self.pump()
        return self.max_depth is None or \
            len(self._inflight) + pending < self.max_depth

    def parked_uids(self) -> Tuple[int, ...]:
        return tuple(self._inflight)

    # ------------------------------------------------------------------
    def publish(self, handoff: KVHandoff, pages: List[Any],
                slot_one: Any = None) -> None:
        """Serialize and send one handoff as a HANDOFF message.

        Metering happens only after a successful send: a
        :class:`TransportError` leaves the credit window and counters
        untouched (the engine requeues the session and releases its quota
        charge).  Bytes a striped channel did put on the wire before a
        stripe died are still metered as ``kv_wire`` (``err.wire_bytes``),
        so the summed-stripe reconciliation stays exact across faults."""
        sess = handoff.session
        req = sess.request
        codec = self.codec_for(sess.tenant) if self.codec_for else None
        trees = list(pages) + ([slot_one] if slot_one is not None else [])
        wired, raw, wire, calls = _encode_trees(trees, codec)
        wired_pages = wired[:len(pages)]
        wired_slot = wired[len(pages)] if slot_one is not None else None
        msg = {
            "schema": SCHEMA_VERSION,
            "uid": sess.uid,
            "tenant": sess.tenant,
            "prompt": np.asarray(req.prompt),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": int(req.eos_id),
            "priority": int(getattr(req, "priority", 0)),
            "deadline": getattr(req, "deadline", None),
            "tokens": [int(t) for t in sess.tokens],
            "length": int(handoff.length),
            "requeues": int(handoff.requeues),
            "pages": [],         # placeholder; the channel ships the pages
            "slot_one": wired_slot,
        }
        try:
            nbytes = _send_handoff_msg(self.channel, msg, wired_pages)
        except TransportError as e:
            partial = int(getattr(e, "wire_bytes", 0))
            if partial:
                self.runtime.meter_transfer("kv_wire", partial, partial)
            raise
        self.sent_msgs += 1
        self.runtime.meter_transfer("kv_publish", raw, wire, calls=calls)
        self.runtime.meter_transfer("kv_wire", nbytes, nbytes)
        self._inflight[sess.uid] = sess
        self.published += 1
        self.shipped_pages += len(pages)

    # ------------------------------------------------------------------
    def pump(self) -> None:
        """Drain control messages (ACK / RESULT / BYE) off the channel."""
        while True:
            got = _poll_msg(self.channel, retries=self._retries,
                            backoff=self._backoff, sleep=self._sleep)
            if got is None:
                return
            kind, msg = got
            self.taken_msgs += 1
            if kind == K_ACK:
                sess = self._inflight.pop(msg["uid"], None)
                if sess is not None:
                    self._adopted[msg["uid"]] = sess
                    self.delivered += 1
            elif kind == K_RESULT:
                self._apply_result(msg)
            elif kind == K_BYE:
                self.peer_done = True
            else:
                raise WireFormatError(
                    f"unexpected frame kind {_KIND_NAMES.get(kind, kind)} "
                    "on the prefill side")

    def _apply_result(self, msg: Dict[str, Any]) -> None:
        uid = msg["uid"]
        sess = self._adopted.pop(uid, None) or self._inflight.pop(uid, None)
        self.results += 1
        if self.quota is not None:
            self.quota.release_uid(uid)
        if sess is None:
            return
        if not sess.done:
            # same list object: keep the Request.out_tokens alias intact
            del sess.tokens[:]
            sess.tokens.extend(msg["tokens"])
            sess.length = int(msg["length"])
            sess.finish(msg["finish_reason"])
        self.completed.append(sess)

    # ------------------------------------------------------------------
    def sweep_cancelled(self) -> List[Session]:
        """CANCEL in-flight sessions their submitter cancelled; returns
        them (the engine releases their quota)."""
        self.pump()
        swept: List[Session] = []
        for store in (self._inflight, self._adopted):
            for uid, sess in list(store.items()):
                if sess.done:
                    del store[uid]
                    self._control(K_CANCEL, {"uid": uid})
                    self.swept += 1
                    swept.append(sess)
        return swept

    def send_bye(self) -> None:
        self._control(K_BYE, {})

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, Any]:
        report = dict(self.runtime.traffic_report())
        report["transfer"] = {
            "published": self.published,
            "delivered": self.delivered,
            "requeued": self.requeued,
            "swept": self.swept,
            "depth": len(self._inflight),
            "shipped_pages": self.shipped_pages,
            "adopted_pages": 0,
            "results": self.results,
        }
        return report

    def describe(self) -> str:
        cap = "" if self.max_depth is None else f"/{self.max_depth}"
        return (f"wire-out[depth={len(self._inflight)}{cap} "
                f"shipped={self.shipped_pages}p results={self.results}]")


class WireReceiver(_WireEnd):
    """Decode-side half of the wire: duck-types the ``TransferQueue``
    surface the decode-role Engine and ``PagedKVCacheManager.adopt`` read
    (``next_ready`` / ``requeue`` / ``fetch_pages`` / ``fetch_slot_leaves``
    / ``discard`` / ``sweep_cancelled``).

    HANDOFF messages rebuild the session (Request fields and the tokens
    emitted so far) and park a :class:`WireHandoff`; adoption ACKs back
    (freeing a sender credit), retirement sends RESULT with the whole
    token stream.  Fetched pages land on the runtime's device before the
    cache installs them.  ``flush_results`` runs
    inside ``sweep_cancelled``, so a plain ``Engine.step`` loop needs no
    extra wiring."""

    def __init__(self, channel: Channel, runtime: MemoryRuntime, *,
                 retries: int = 10, backoff: float = 0.005,
                 sleep=time.sleep):
        self.channel = channel
        self.runtime = runtime
        self._retries, self._backoff, self._sleep = retries, backoff, sleep
        self._parked: Deque[WireHandoff] = deque()
        self._sessions: Dict[int, Session] = {}
        self._result_sent: set = set()
        self._seq = 0
        self.peer_done = False
        self.published = 0          # HANDOFF messages received
        self.delivered = 0
        self.requeued = 0
        self.swept = 0
        self.shipped_pages = 0
        self.adopted_pages = 0

    # ------------------------------------------------------------------
    def _restore_session(self, msg: Dict[str, Any]) -> Session:
        from repro_torch.serve.engine import Request   # engine imports us
        req = Request(uid=msg["uid"], prompt=msg["prompt"],
                      max_new_tokens=msg["max_new_tokens"],
                      eos_id=msg["eos_id"], priority=msg["priority"],
                      tenant=msg["tenant"], deadline=msg["deadline"])
        sess = Session(request=req, seq=self._seq)
        self._seq += 1
        sess.tokens.extend(msg["tokens"])
        sess.length = msg["length"]
        return sess

    def pump(self) -> None:
        while True:
            got = _poll_msg(self.channel, retries=self._retries,
                            backoff=self._backoff, sleep=self._sleep)
            if got is None:
                return
            kind, msg = got
            self.taken_msgs += 1
            if kind == K_HANDOFF:
                if msg["schema"] != SCHEMA_VERSION:
                    raise WireFormatError(
                        f"handoff header schema v{msg['schema']} != "
                        f"v{SCHEMA_VERSION}")
                sess = self._restore_session(msg)
                self._sessions[sess.uid] = sess
                self._parked.append(WireHandoff(
                    sess, msg["length"], msg["pages"], msg["slot_one"],
                    requeues=msg["requeues"]))
                self.published += 1
                self.shipped_pages += len(msg["pages"])
            elif kind == K_CANCEL:
                sess = self._sessions.get(msg["uid"])
                if sess is not None and not sess.done:
                    sess.cancel()
            elif kind == K_BYE:
                self.peer_done = True
            else:
                raise WireFormatError(
                    f"unexpected frame kind {_KIND_NAMES.get(kind, kind)} "
                    "on the decode side")

    # ------------------------------------------------------------------
    def depth(self) -> int:
        self.pump()
        return len(self._parked)

    def has_room(self, pending: int = 0) -> bool:
        return True                  # the sender's credit window bounds us

    def parked_uids(self) -> Tuple[int, ...]:
        return tuple(h.uid for h in self._parked)

    def next_ready(self) -> Optional[WireHandoff]:
        self.pump()
        if not self._parked:
            return None
        self.delivered += 1
        return self._parked.popleft()

    def requeue(self, handoff: WireHandoff) -> None:
        handoff.requeues += 1
        self.requeued += 1
        self._parked.append(handoff)

    # ------------------------------------------------------------------
    def _ack(self, handoff: WireHandoff) -> None:
        self._control(K_ACK, {"uid": handoff.uid})

    def fetch_pages(self, handoff: WireHandoff) -> List[Any]:
        """The shipped pages on the device, in logical order (metered
        ``kv_adopt``: raw = tensor bytes, wire = encoded bytes); ACKs the
        adoption, freeing the sender's credit."""
        raw, wire, calls = _adopt_bytes(handoff.pages)
        pages = _decode_trees(handoff.pages, self.runtime.device)
        self.runtime.meter_transfer("kv_adopt", raw, wire, calls=calls)
        self.adopted_pages += len(pages)
        handoff.pages = []
        self._ack(handoff)
        return pages

    def fetch_slot_leaves(self, handoff: WireHandoff) -> Any:
        if handoff.slot_one is None:
            return None
        raw, wire, calls = _adopt_bytes([handoff.slot_one])
        self.runtime.meter_transfer("kv_adopt", raw, wire, calls=calls)
        (out,) = _decode_trees([handoff.slot_one], self.runtime.device)
        handoff.slot_one = None
        return out

    def discard(self, handoff: WireHandoff) -> None:
        """Drop an unconsumed handoff (cancelled in transit) and ACK so the
        sender's credit frees anyway."""
        handoff.pages = []
        handoff.slot_one = None
        self._ack(handoff)

    # ------------------------------------------------------------------
    def sweep_cancelled(self) -> List[Session]:
        self.pump()
        swept: List[Session] = []
        for handoff in [h for h in self._parked if h.session.done]:
            self._parked.remove(handoff)
            self.discard(handoff)
            self.swept += 1
            swept.append(handoff.session)
        self.flush_results()
        return swept

    def flush_results(self) -> None:
        """Send RESULT for every locally retired session, exactly once."""
        parked = {h.uid for h in self._parked}
        for uid, sess in list(self._sessions.items()):
            if not sess.done or uid in self._result_sent or uid in parked:
                continue
            self._control(K_RESULT, {
                "uid": int(uid),
                "tokens": [int(t) for t in sess.tokens],
                "length": int(sess.length),
                "finish_reason": sess.finish_reason or FINISH_CANCELLED,
            })
            self._result_sent.add(uid)

    def pending_results(self) -> int:
        parked = {h.uid for h in self._parked}
        return sum(1 for uid, s in self._sessions.items()
                   if s.done and uid not in self._result_sent
                   and uid not in parked)

    def send_bye(self) -> None:
        self._control(K_BYE, {})

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, Any]:
        report = dict(self.runtime.traffic_report())
        report["transfer"] = {
            "published": self.published,
            "delivered": self.delivered,
            "requeued": self.requeued,
            "swept": self.swept,
            "depth": len(self._parked),
            "shipped_pages": self.shipped_pages,
            "adopted_pages": self.adopted_pages,
        }
        return report

    def describe(self) -> str:
        return (f"wire-in[depth={len(self._parked)} "
                f"adopted={self.adopted_pages}p requeued={self.requeued}]")


# ---------------------------------------------------------------------------
def _wire_runtime(model) -> MemoryRuntime:
    """A metering runtime for one wire endpoint (kv_wire / kv_publish /
    kv_adopt accounting; nothing is stashed through its tier)."""
    return MemoryRuntime(
        model.plan,
        MemoryPlan(policy="host", placement=model.memory.placement),
        model.device)


def _shared_quota(quota) -> Optional[QuotaManager]:
    if quota is None or isinstance(quota, QuotaManager):
        return quota
    if isinstance(quota, TenantQuota):
        return QuotaManager(default_quota=quota)
    return QuotaManager(dict(quota))


class WirePrefill:
    """Prefill half of a cross-process pair: a local prefill engine and its
    :class:`WireSender`; the decode engine lives behind the channel.
    Steppable and routable like a
    :class:`~repro_torch.serve.disagg.DisaggPair` (``decode is None`` marks
    the remote half)."""

    decode = None

    def __init__(self, prefill, sender: WireSender,
                 window_hint: Optional[int] = None):
        if prefill.role != "prefill" or prefill.transfer is not sender:
            raise ValueError("need a prefill-role engine driving THIS "
                             "WireSender")
        self.prefill = prefill
        self.transfer = sender
        self.window_hint = window_hint

    def submit(self, req=None, on_token=None, session=None) -> Session:
        return self.prefill.submit(req, on_token=on_token, session=session)

    def step(self) -> int:
        shipped = self.prefill.step()
        self.transfer.pump()
        return shipped + self.transfer.outstanding()

    def has_work(self) -> bool:
        return (self.prefill.scheduler.has_waiting()
                or bool(self.prefill.cache.running())
                or self.transfer.outstanding() > 0)

    def run(self, max_steps: int = 100_000, idle_sleep: float = 0.002,
            sleep=time.sleep) -> List[Any]:
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
            if not (self.prefill.scheduler.has_waiting()
                    or self.prefill.cache.running()):
                sleep(idle_sleep)     # only the remote decode has work
        return self.prefill.finished + \
            [s.request for s in self.transfer.completed]

    def close(self) -> None:
        self.transfer.send_bye()
        # the channel too: striped worker threads join and an shm arena
        # unlinks here (BYE is already queued; the peer drains it)
        self.transfer.channel.close()

    def traffic_report(self) -> Dict[str, Any]:
        return {"transfer": self.transfer.traffic_report(),
                "prefill": self.prefill.traffic_report()}

    def quota_report(self) -> Dict[str, Any]:
        return self.prefill.quota_report()

    def describe(self) -> str:
        return (f"wire-prefill[{self.prefill.describe()} -> "
                f"{self.transfer.describe()}]")


class WirePair:
    """Both halves in one process, joined by a real (byte-serialized)
    channel pair: the wire twin of the loopback
    :class:`~repro_torch.serve.disagg.DisaggPair`.  Every page crosses the
    channel as frames, and the token streams match the loopback's."""

    def __init__(self, prefill, decode, sender: WireSender,
                 receiver: WireReceiver):
        if prefill.role != "prefill" or decode.role != "decode":
            raise ValueError(f"need (prefill, decode) roles, got "
                             f"({prefill.role!r}, {decode.role!r})")
        if prefill.transfer is not sender or decode.transfer is not receiver:
            raise ValueError("engines must drive THIS sender/receiver pair")
        if prefill._page_size != decode.cache.page_size:
            raise ValueError(
                f"page_size mismatch: prefill ships {prefill._page_size}-row "
                f"pages, decode pools {decode.cache.page_size}-row frames")
        if prefill.max_len != decode.max_len:
            raise ValueError(f"max_len mismatch: {prefill.max_len} vs "
                             f"{decode.max_len}")
        self.prefill = prefill
        self.decode = decode
        self.sender = sender
        self.receiver = receiver
        # router-facing alias: the pair's transfer depth is the sender's
        # credit window (parked on either side of the wire)
        self.transfer = sender

    # ------------------------------------------------------------------
    def submit(self, req=None, on_token=None, session=None) -> Session:
        return self.prefill.submit(req, on_token=on_token, session=session)

    def step(self) -> int:
        shipped = self.prefill.step()
        self._settle(self.sender, self.receiver)
        active = self.decode.step()
        self.receiver.flush_results()
        self._settle(self.receiver, self.sender)
        self.sender.pump()
        return shipped + active

    @staticmethod
    def _settle(src: _WireEnd, dst: _WireEnd) -> None:
        """Take in at ``dst`` every message ``src`` has sent whole.  Both
        halves share this process, so each step sees what the loopback
        pair's would however late the channel lands a frame (a socket
        under load can land one after the peer's next poll); a message a
        fault lost is given up after ``SETTLE_S``."""
        deadline = time.monotonic() + SETTLE_S
        while dst.taken_msgs < src.sent_msgs:
            dst.pump()
            if (dst.taken_msgs >= src.sent_msgs or dst.channel.closed
                    or time.monotonic() > deadline):
                return
            time.sleep(SETTLE_NAP_S)

    def has_work(self) -> bool:
        return (self.prefill.scheduler.has_waiting()
                or bool(self.prefill.cache.running())
                or self.sender.outstanding() > 0
                or self.receiver.depth() > 0
                or self.receiver.pending_results() > 0
                or self.decode.scheduler.has_waiting()
                or bool(self.decode.cache.running()))

    def run(self, max_steps: int = 10_000) -> List[Any]:
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
        return self.prefill.finished + \
            [s.request for s in self.sender.completed]

    def close(self) -> None:
        """Close both channel ends (joins striped workers, unlinks an shm
        arena)."""
        self.sender.channel.close()
        self.receiver.channel.close()

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, Any]:
        return {"wire_out": self.sender.traffic_report(),
                "wire_in": self.receiver.traffic_report(),
                "decode": self.decode.traffic_report(),
                "prefill": self.prefill.traffic_report()}

    def quota_report(self) -> Dict[str, Any]:
        return self.prefill.quota_report()

    def describe(self) -> str:
        return (f"wire[{self.prefill.describe()} -> "
                f"{self.sender.describe()} | {self.receiver.describe()} "
                f"-> {self.decode.describe()}]")


# ---------------------------------------------------------------------------
def build_wire_pair(model, params, *,
                    transport: str = "memory",
                    channels: Optional[Tuple[Channel, Channel]] = None,
                    batch: Optional[int] = None,
                    max_len: Optional[int] = None,
                    page_size: int = 16,
                    pages: Optional[int] = None,
                    prefill_batch: int = 1,
                    max_depth: Optional[int] = None,
                    scheduler: Union[str, Any] = "fcfs",
                    decode_scheduler: Union[str, Any, None] = None,
                    spill: Union[str, Any, None] = "spill",
                    quota: Union[QuotaManager, TenantQuota,
                                 Dict[str, TenantQuota], None] = None,
                    wire_codec: Union[bool, str, None] = None,
                    streams: int = 1,
                    temperature: float = 0.0, seed: int = 0,
                    **cache_kwargs) -> WirePair:
    """A prefill/decode pair over a real byte channel.

    Mirrors :func:`~repro_torch.serve.disagg.build_disagg` (the decode
    side samples from ``seed + 1``) with the loopback queue replaced by a
    serialized channel.  ``wire_codec``: None, raw pages; ``True``, each
    tenant's quota codec (``QuotaManager.codec_for``); a codec name, that
    codec for every tenant.  ``streams`` > 1 stripes handoffs over that
    many sub-channels of ``transport`` (not ``"shm"``, already
    header-only on its one control pipe).  ``cache_kwargs``
    (``decode_kernel=True`` among them) go to the decode engine."""
    from repro_torch.serve.engine import Engine   # engine imports us

    if streams < 1:
        raise ValueError(f"streams must be >= 1: {streams}")
    if channels is not None:
        tx, rx = channels
    elif streams > 1:
        if transport == "shm":
            raise ValueError("shm is single-control-socket; striping it "
                             "is meaningless — use streams=1")
        tx, rx = striped_pair(streams, base=transport)
    else:
        tx, rx = build_transport(transport)

    shared_quota = _shared_quota(quota)
    if wire_codec is True:
        codec_for = shared_quota.codec_for if shared_quota else None
    elif isinstance(wire_codec, str):
        get_codec(wire_codec)               # raise early on unknown codec
        codec_for = lambda tenant: wire_codec   # noqa: E731
    else:
        codec_for = None

    if decode_scheduler is None:
        decode_scheduler = scheduler if isinstance(scheduler, str) else "fcfs"

    sender = WireSender(tx, _wire_runtime(model), max_depth=max_depth,
                        codec_for=codec_for, quota=shared_quota)
    receiver = WireReceiver(rx, _wire_runtime(model))

    decode = Engine(model, params, batch=batch, max_len=max_len,
                    temperature=temperature, seed=seed + 1,
                    scheduler=decode_scheduler, spill=spill,
                    page_size=page_size, pages=pages, quota=shared_quota,
                    role="decode", transfer=receiver, **cache_kwargs)
    prefill = Engine(model, params, batch=prefill_batch,
                     max_len=decode.max_len,
                     temperature=temperature, seed=seed,
                     scheduler=scheduler, spill=None,
                     page_size=page_size, quota=shared_quota,
                     role="prefill", transfer=sender)
    return WirePair(prefill, decode, sender, receiver)


def build_wire_prefill(model, params, channel: Channel, *,
                       max_len: Optional[int] = None,
                       page_size: int = 16,
                       prefill_batch: int = 1,
                       max_depth: Optional[int] = None,
                       scheduler: Union[str, Any] = "fcfs",
                       quota: Optional[QuotaManager] = None,
                       wire_codec: Optional[str] = None,
                       window_hint: Optional[int] = None,
                       temperature: float = 0.0,
                       seed: int = 0) -> WirePrefill:
    """The prefill half of a two-process deployment (decode is remote)."""
    from repro_torch.serve.engine import Engine

    codec_for = (lambda tenant: wire_codec) if wire_codec else None
    sender = WireSender(channel, _wire_runtime(model), max_depth=max_depth,
                        codec_for=codec_for, quota=quota)
    prefill = Engine(model, params, batch=prefill_batch, max_len=max_len,
                     temperature=temperature, seed=seed,
                     scheduler=scheduler, spill=None, page_size=page_size,
                     quota=quota, role="prefill", transfer=sender)
    return WirePrefill(prefill, sender, window_hint=window_hint)


def run_decode_worker(model, params, channel: Channel, *,
                      batch: Optional[int] = None,
                      max_len: Optional[int] = None,
                      page_size: int = 16,
                      pages: Optional[int] = None,
                      scheduler: Union[str, Any] = "fcfs",
                      spill: Union[str, Any, None] = "spill",
                      quota: Optional[QuotaManager] = None,
                      temperature: float = 0.0, seed: int = 1,
                      max_steps: int = 1_000_000,
                      idle_sleep: float = 0.002, sleep=time.sleep,
                      **cache_kwargs):
    """Decode-worker main loop of the two-process deployment.

    Adopts handoffs off ``channel``, decodes, RESULTs back; exits when the
    prefill side says BYE and everything local has retired.  ``seed`` must
    be the prefill side's ``seed + 1`` for the streams to match the
    loopback's.  ``quota`` gives the spill its tenants' codecs (its
    ledger is this process's own); ``cache_kwargs`` (``decode_kernel=True``
    among them) go to the engine.  Returns the decode engine (its traffic report prices
    the adopted bytes)."""
    from repro_torch.serve.engine import Engine

    receiver = WireReceiver(channel, _wire_runtime(model))
    eng = Engine(model, params, batch=batch, max_len=max_len,
                 temperature=temperature, seed=seed, scheduler=scheduler,
                 spill=spill, page_size=page_size, pages=pages,
                 quota=quota, role="decode", transfer=receiver,
                 **cache_kwargs)
    for _ in range(max_steps):
        busy = eng.step()
        receiver.flush_results()
        idle = (busy == 0 and not eng.scheduler.has_waiting()
                and not eng.cache.running() and receiver.depth() == 0
                and receiver.pending_results() == 0)
        if idle and (receiver.peer_done or channel.closed):
            break
        if idle:
            sleep(idle_sleep)        # poll the channel for the next frame
    try:
        receiver.send_bye()          # courtesy only: the peer that said
    except TransportError:           # BYE may have hung up already
        pass
    channel.close()
    return eng
