"""Decoupled ingest: reader thread -> ring/queue -> upload thread -> device.

Device-side equivalent of the reference's input pthread + cbuffercf
one2one connection (/root/reference/src/block.c:55,
src/input-soapysdr.c:226, src/input-file.c:35): while the device crunches
block N, the reader fills block N+1 and a background thread moves it to
device memory, so the steady-state block period is max(read, transfer,
compute) instead of their sum.

Raw SDR formats upload in their native width and convert on device
(utils/xfer.device_put_cs16_raw / device_put_cu8_raw) -- half (CS16) or a
quarter (CU8) of the float-pair bytes over the interconnect, bit-exact
with the host converters (io/formats.py, input-helpers.c:10-78).
"""

from __future__ import annotations

import queue
import threading
import time
from collections.abc import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.xfer import (device_put_cs16, device_put_cs16_raw,
                          device_put_cu8_raw)
from . import formats
from .native import SampleRing


def upload(raw, fmt: str) -> jax.Array:
    """Raw samples (bytes or the format's natural numpy dtype) -> device
    complex64, converting on device for the integer formats."""
    fmt = fmt.upper()
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    if fmt == 'CS16':
        return device_put_cs16_raw(raw)
    if fmt == 'CU8':
        return device_put_cu8_raw(raw)
    if fmt == 'CF32':
        if raw.dtype != np.complex64:
            raw = raw.view(np.uint8).copy().view(np.complex64) \
                if raw.dtype == np.uint8 else np.asarray(raw, np.complex64)
        return jnp.asarray(raw)
    raise ValueError(f'unknown sample format {fmt}')


def file_chunks(fh, fmt: str, chunk_bytes: int,
                stop: threading.Event | None = None,
                pad_final: bool = False) -> Iterator[np.ndarray]:
    """Read fixed-size raw chunks (accumulating short reads, so pipes
    deliver full blocks like the reference's blocking fread,
    input-file.c:35-52); the final chunk may be shorter -- unless
    pad_final, which silence-pads it to exactly chunk_bytes (for
    fixed-shape consumers like the superstep)."""
    bps = formats.bytes_per_sample(fmt)
    chunk_bytes = max(bps, chunk_bytes - chunk_bytes % bps)
    pending = b''
    eof = False
    while not eof and not (stop is not None and stop.is_set()):
        while len(pending) < chunk_bytes:
            data = fh.read(chunk_bytes - len(pending))
            if not data:
                eof = True
                break
            pending += data
        emit = pending[:len(pending) - len(pending) % bps]
        pending = pending[len(emit):]
        if emit and pad_final and len(emit) < chunk_bytes:
            out = np.full(chunk_bytes, formats.silence_byte(fmt), np.uint8)
            out[:len(emit)] = np.frombuffer(emit, np.uint8)
            yield out
        elif emit:
            yield np.frombuffer(emit, dtype=np.uint8)


def uploaded_stream(raw_iter: Iterable, fmt: str, depth: int = 2,
                    packed: bool = False) -> Iterator[jax.Array]:
    """Yield device-resident complex64 blocks for an iterable of raw host
    chunks; a daemon thread runs `depth` uploads ahead of the consumer
    (bounded queue = backpressure on the reader).

    packed=True additionally quantizes CF32 input to CS16 precision for
    half the transfer bytes (live-SDR fidelity; see device_put_cs16)."""
    if packed and fmt.upper() == 'CF32':
        put = device_put_cs16
    else:
        put = lambda raw: upload(raw, fmt)
    q: queue.Queue = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def worker():
        try:
            for raw in raw_iter:
                q.put(put(raw))
        except BaseException as e:          # surface errors to the consumer
            q.put((SENTINEL, e))
            return
        q.put((SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True, name='ingest-upload')
    t.start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item


def superstep_stream(receiver, raw_iter: Iterable, depth: int = 2
                     ) -> Iterator[jax.Array]:
    """Upload thread for the superstep path: each fixed-size raw chunk
    becomes the packed device array the superstep program consumes (no
    separate convert dispatch; see SuperstepEngine.upload), `depth` ahead
    of the consumer."""
    ss = receiver.superstep
    q: queue.Queue = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def worker():
        try:
            for raw in raw_iter:
                q.put(ss.upload(raw))
        except BaseException as e:
            q.put((SENTINEL, e))
            return
        q.put((SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True, name='ss-upload')
    t.start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item


class StreamIngest:
    """Live-source ingest: a reader thread drains `sample_iter` (complex64
    chunks of any length) into the lock-free SPSC SampleRing; `blocks()`
    assembles fixed-size blocks for the uploader.

    The ring decouples the SDR read cadence from the compute block size
    exactly like the reference's input thread + ring (block.c:15-33);
    overruns (ring full while real-time source keeps producing) are
    counted, not blocked on, mirroring complex_samples_produce
    (input-helpers.c:80-92)."""

    def __init__(self, sample_iter: Iterable[np.ndarray], block_samples: int,
                 ring_capacity: int | None = None,
                 stop: threading.Event | None = None):
        self.block = int(block_samples)
        self.ring = SampleRing(ring_capacity or 8 * self.block)
        self.stop_event = stop or threading.Event()
        self._done = threading.Event()
        self._exc: BaseException | None = None

        def reader():
            try:
                for chunk in sample_iter:
                    if self.stop_event.is_set():
                        break
                    self.ring.write(np.asarray(chunk, np.complex64))
            except BaseException as e:
                self._exc = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=reader, daemon=True,
                                        name='ingest-reader')
        self._thread.start()

    @property
    def overruns(self) -> int:
        return self.ring.overruns

    def stop(self) -> None:
        self.stop_event.set()

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield (block,) complex64 arrays; the final partial block is
        zero-padded (trailing silence) so every block has a static shape."""
        while True:
            n = len(self.ring)
            if n >= self.block:
                yield self.ring.read(self.block)
                continue
            if self._done.is_set() or self.stop_event.is_set():
                if n:
                    tail = self.ring.read(n)
                    yield np.pad(tail, (0, self.block - len(tail)))
                break
            time.sleep(0.002)
        if self._exc is not None:
            raise self._exc
