"""Length-prefixed, CRC-framed pickle transport over a socketpair
(DESIGN.md §11, §12).

One AF_UNIX ``socketpair`` per worker, created by the parent and passed
to the subprocess by fd inheritance (``REPRO_SHARD_WORKER_FD``). Frames
are ``8-byte big-endian length || 4-byte crc32 || pickle payload``; a
frame is a 3-tuple:

    request:  (req_id, method, args_blob)     args_blob = pickle(dict)
    response: (req_id, ok, payload)           payload = result | exc

``args_blob`` is pre-pickled *bytes inside the frame* so a broadcast
(replicated dimension-table ingest) serializes the — potentially large —
array payload ONCE and fans the same blob to every worker; the outer
frame per worker differs only by its req_id.

Integrity: the CRC covers the pickle payload. On mismatch ``recv``
raises :class:`FrameCorrupt` — crucially AFTER consuming the full
declared length, so the stream stays frame-aligned and the reader can
skip the bad frame and keep going (the sender's retry/backoff layer
re-sends; see ``proc/backend.py``). Without the CRC a flipped bit
becomes a pickle crash or, worse, silently wrong data.

Fault injection: a :class:`~repro_torch.shard.proc.faults.FaultInjector`
assigned to ``Channel.fault_injector`` intercepts every outbound frame
(drop / delay / duplicate / corrupt / kill-on-nth) — the chaos suite's
only hook into the wire, so production paths carry zero fault branches.

Sends are locked (many lanes share one worker channel); receives are
single-reader (the parent's per-worker reader thread / the worker's
serve loop). Numpy arrays ride pickle protocol 5 buffer support where
available — on one host this is a memcpy, not an encode. Tensors never
ride a frame: :func:`to_host` turns them into numpy first (a CUDA tensor
would unpickle onto ``cuda:<index>`` of the reading process), marked
where the reader must rebuild them on its own device (:func:`to_device`).
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["Channel", "FrameCorrupt", "encode_args", "decode_args",
           "HostTensor", "to_host", "to_device"]

_HDR = struct.Struct(">QI")          # payload length, crc32(payload)
_PROTO = pickle.HIGHEST_PROTOCOL


class FrameCorrupt(RuntimeError):
    """A received frame failed its CRC (or would not unpickle). The
    stream is still aligned — the full frame was consumed — so this is
    RETRYABLE: drop the frame, count it, read the next one."""


class HostTensor:
    """A tensor on its way across the process boundary as numpy; the
    receiving side rebuilds it on its own device (:func:`to_device`)."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


def to_host(obj, *, mark: bool = False):
    """``obj`` with every tensor (in dicts, lists, tuples) copied to host
    numpy; with ``mark``, each as a :class:`HostTensor` so the receiver
    can make it a tensor again."""
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return HostTensor(a) if mark else a
    if isinstance(obj, dict):
        return {k: to_host(v, mark=mark) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v, mark=mark) for v in obj)
    return obj


def to_device(obj, device):
    """Undo ``to_host(..., mark=True)``: each :class:`HostTensor` becomes
    a tensor of its dtype on ``device``; everything else stays."""
    if isinstance(obj, HostTensor):
        return torch.from_numpy(np.array(obj.array)).to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def encode_args(args: dict) -> bytes:
    """Pickle an RPC's kwargs once — shareable across a broadcast."""
    return pickle.dumps(args, protocol=_PROTO)


def decode_args(blob: bytes) -> dict:
    return pickle.loads(blob)


class Channel:
    """One framed, thread-safe-send / single-reader pickle channel."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        # chaos hook — installed only AFTER the hello/ready handshake so
        # bootstrap frames are never dropped (proc/faults.py)
        self.fault_injector = None  # type: Optional[Any]

    # -------------------------------------------------------------- send
    def send(self, obj: Tuple) -> None:
        payload = pickle.dumps(obj, protocol=_PROTO)
        inj = self.fault_injector
        if inj is None:
            frames = [(payload, zlib.crc32(payload))]
        else:
            # the injector decides what actually hits the wire: [] drops
            # the frame, two entries duplicate it, a mutated payload
            # under the ORIGINAL crc models on-wire corruption (length
            # unchanged, so the receiver stays frame-aligned)
            frames = inj.frames(payload)
        with self._send_lock:
            for p, crc in frames:
                self._sock.sendall(_HDR.pack(len(p), crc) + p)

    # -------------------------------------------------------------- recv
    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("channel peer closed")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self) -> Any:
        """Blocking read of one frame. Raises ``EOFError`` when the peer
        is gone (worker death / parent exit) and ``FrameCorrupt`` on a
        CRC/unpickle failure — after consuming the whole frame, so the
        caller may simply read the next one."""
        length, crc = _HDR.unpack(self._recv_exact(_HDR.size))
        payload = self._recv_exact(length)      # always consume: stay aligned
        if zlib.crc32(payload) != crc:
            raise FrameCorrupt(
                f"frame of {length} bytes failed crc32 check")
        try:
            return pickle.loads(payload)
        except Exception as e:                  # garbage that passed CRC
            raise FrameCorrupt(f"frame would not unpickle: {e!r}") from e

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed
