"""Application orchestration: input -> receiver -> protocol -> outputs.

Equivalent of the reference's main-thread wiring and supervision
(/root/reference/src/main.c:322-835), with the block graph replaced by
the batched WidebandReceiver.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time as time_mod

import numpy as np

from . import constants as C
from .dsp.channel import FrameEvent
from .dsp.receiver import WidebandReceiver
from .io.outputs import OutputManager
from .protocol.pdu import PduMetadata, parse_pdu
from .protocol.runtime import ProtocolContext


def level_to_db(level: float) -> float:
    return 20.0 * math.log10(max(level, 1e-12))


@dataclasses.dataclass
class AppConfig:
    frequencies: list[int]              # Hz
    sample_rate: int
    centerfreq: int | None = None       # Hz; None -> auto midpoint
    freq_offset: int = 0                # --freq-offset
    read_buffer_size: int = 320_000     # bytes (input-file.c:15)
    sample_format: str = 'CF32'
    output_queue_hwm: int = 1000
    nf_stats_interval: int = 10
    mesh: str | None = None             # 'TIMExCHAN' device mesh, e.g. '2x4'
    # demod block length in 5400-sps samples: longer blocks amortize the
    # fixed per-block dispatch and event readback at the cost of event
    # latency; must obey the symbol-ring history invariant (<= 5400
    # symbols)
    demod_block_len: int = 5400
    # live-stream ingest chunk (wideband samples per upload); None = fs/8
    # (~0.2 s, low latency).  Larger chunks mean fewer, larger uploads.
    stream_chunk_samples: int | None = None


def compute_centerfreq(frequencies: list[int], sample_rate: int,
                       centerfreq: int | None) -> int:
    """main.c:214-239: auto centerfreq = midpoint; span check."""
    fmin, fmax = min(frequencies), max(frequencies)
    if fmax - fmin > sample_rate:
        raise ValueError(
            f'channel span {fmax - fmin} Hz exceeds sample rate {sample_rate}')
    if centerfreq is None:
        centerfreq = (fmin + fmax) // 2
    return centerfreq


class HfdlApp:
    def __init__(self, cfg: AppConfig, ctx: ProtocolContext,
                 outputs: OutputManager,
                 statsd=None):
        self.cfg = cfg
        self.ctx = ctx
        self.outputs = outputs
        self.statsd = statsd
        centerfreq = compute_centerfreq(cfg.frequencies, cfg.sample_rate,
                                        cfg.centerfreq)
        self.centerfreq = centerfreq + cfg.freq_offset
        if cfg.mesh:
            # multi-chip decode on a ('time','chan') mesh: frontend work
            # shards over 'time' with halo collective-permute, demod
            # channels shard over all devices (parallel/sharding.py)
            import jax
            from jax.sharding import Mesh
            from .parallel.sharding import ShardedWidebandReceiver
            t_str, _, k_str = cfg.mesh.lower().partition('x')
            t_ax, k_ax = int(t_str), int(k_str)
            devices = jax.devices()
            if t_ax * k_ax > len(devices):
                raise ValueError(
                    f'mesh {cfg.mesh} needs {t_ax * k_ax} devices, '
                    f'have {len(devices)}')
            mesh = Mesh(np.asarray(devices[:t_ax * k_ax]).reshape(t_ax, k_ax),
                        ('time', 'chan'))
            self.receiver = ShardedWidebandReceiver(
                cfg.sample_rate, self.centerfreq, list(cfg.frequencies),
                mesh=mesh, block_len=cfg.demod_block_len)
        else:
            self.receiver = WidebandReceiver(cfg.sample_rate, self.centerfreq,
                                             list(cfg.frequencies),
                                             block_len=cfg.demod_block_len,
                                             sample_format=cfg.sample_format)
        self.stream_epoch = time_mod.time()
        self.frames_decoded = 0     # FCS-valid frames parsed
        self.frames_junk = 0        # FCS-fail frames (false locks/errors)
        self._stop = threading.Event()
        self._nf_thread = None

    # -- frame handling --

    def _metadata_for(self, ev: FrameEvent) -> PduMetadata:
        p = C.MODES[ev.mode]
        # the superstep's one-block resampler delay shifts the tracker's
        # symbol clock relative to the stream epoch
        ss = getattr(self.receiver, 'superstep', None)
        off = ss.delay_symbols if ss is not None else 0
        ts = self.stream_epoch + max(ev.start_symbol - off, 0) / C.SYMBOL_RATE
        return PduMetadata(
            freq=self.cfg.frequencies[ev.channel],
            freq_err_hz=ev.freq_err_hz,
            rssi=level_to_db(ev.rssi),
            noise_floor=level_to_db(ev.noise_floor),
            bit_rate=p.bit_rate,
            slot=p.slot,
            rx_timestamp=ts,
        )

    def publish_demod_counters(self) -> None:
        """Push per-channel preamble counters to StatsD (statsd.c:17-49)."""
        if self.statsd is None:
            return
        counters = getattr(self.receiver.bank, 'last_counters', None)
        if counters is None:
            return
        c = np.asarray(counters)
        names = ('demod.preamble.A2_found', 'demod.preamble.M1_found',
                 'demod.preamble.errors.M1_not_found',
                 'demod.errors.event_table_overflow')
        for i, freq in enumerate(self.cfg.frequencies):
            for j, name in enumerate(names):
                n = int(c[i, j])
                for _ in range(n):
                    self.statsd.increment_per_channel(freq, name)

    def handle_events(self, events: list[FrameEvent]) -> None:
        self.publish_demod_counters()
        for ev in events:
            if ev.pdu is None:
                continue
            meta = self._metadata_for(ev)
            if not ev.fcs_ok:
                # junk frame (noise false-lock / uncorrected errors,
                # verdict from the device FCS kernel): account it without
                # burning deep-parse time -- unless corrupted-PDU output
                # is requested, in which case the parsers handle it
                self.frames_junk += 1
                if self.ctx.options.output_corrupted_pdus:
                    trees = parse_pdu(ev.pdu, meta, self.ctx)
                    if trees:
                        self.outputs.dispatch(meta, trees)
                else:
                    self._count_junk(ev.pdu, meta)
                continue
            trees = parse_pdu(ev.pdu, meta, self.ctx)
            self.frames_decoded += 1
            if trees:
                self.outputs.dispatch(meta, trees)

    def _count_junk(self, pdu: bytes, meta: PduMetadata) -> None:
        """StatsD parity for skipped junk frames (the counters the
        parsers would have incremented: frames.processed +
        too_short/bad_fcs, mpdu.c:56-89 / spdu.c:40)."""
        statsd = self.ctx.statsd
        statsd.increment_per_channel(meta.freq, 'frames.processed')
        from .ops.crc import pdu_hdr_len
        if pdu_hdr_len(pdu) is None:
            statsd.increment_per_channel(meta.freq,
                                         'frame.errors.too_short')
        else:
            statsd.increment_per_channel(meta.freq, 'frame.errors.bad_fcs')

    # -- main loops --

    def run_file(self, path: str, sample_format: str | None = None) -> int:
        """Offline decode of a raw I/Q file ('-' = stdin, input-file.c).

        The read -> convert -> upload chain runs on a background thread
        (io/ingest.py) so host ingest overlaps device compute, and the
        integer formats upload in native width with on-device conversion."""
        from .io import formats, ingest
        fmt = (sample_format or self.cfg.sample_format).upper()
        fh = sys.stdin.buffer if path == '-' else open(path, 'rb')
        self._start_nf_stats()
        try:
            ss = getattr(self.receiver, 'superstep', None)
            if ss is not None and ss.input_kind == fmt \
                    and getattr(self.receiver.bank, 'dumps', None) is None:
                # one-dispatch-per-super-block path: fixed-size raw
                # chunks, packed upload, single fused program
                raw_iter = ingest.file_chunks(
                    fh, fmt, self.receiver.raw_chunk_bytes,
                    stop=self._stop, pad_final=True)
                for pk in ingest.superstep_stream(self.receiver, raw_iter):
                    if self._stop.is_set():
                        break
                    self.handle_events(self.receiver.process_packed(pk))
                self.handle_events(self.receiver.flush())
                return 0
            raw_iter = ingest.file_chunks(fh, fmt, self.cfg.read_buffer_size,
                                          stop=self._stop)
            if self.cfg.mesh:
                # the sharded receiver splits each super-block across the
                # 'time' mesh axis itself; feed host chunks directly so
                # samples cross to the devices exactly once (sharded)
                stream = (formats.convert(raw, fmt) for raw in raw_iter)
            else:
                stream = ingest.uploaded_stream(raw_iter, fmt)
            for xd in stream:
                if self._stop.is_set():
                    break
                self.handle_events(self.receiver.process(xd))
            self.handle_events(self.receiver.flush())
        finally:
            if path != '-':
                fh.close()
            self._stop.set()
        return 0

    def run_stream(self, sample_iter, packed: bool = False) -> int:
        """Decode an iterator of complex64 chunks (live sources).

        A reader thread drains the source into the lock-free SampleRing
        (native/hfdl_host.cpp), fixed blocks are uploaded one step ahead
        of compute, and ring overruns are counted like the reference's
        complex_samples_produce (input-helpers.c:80-92).  packed=True
        uploads at CS16 precision (half the bytes; for SDR sources whose
        native format is already integer)."""
        from .io import ingest
        self._start_nf_stats()
        ss = getattr(self.receiver, 'superstep', None)
        use_ss = (ss is not None and ss.input_kind in ('CF32', 'CS16')
                  and getattr(self.receiver.bank, 'dumps', None) is None)
        if use_ss:
            # superstep live path: fixed super-block cadence straight off
            # the ingest ring, one fused dispatch per block
            block = ss.plan.wb_chunk
        else:
            block = self.cfg.stream_chunk_samples or max(
                32768, 1 << int(math.ceil(math.log2(
                    max(self.cfg.sample_rate // 8, 1)))))
        src = ingest.StreamIngest(sample_iter, block,
                                  ring_capacity=4 * block, stop=self._stop)
        last_over = 0
        if self.cfg.mesh:
            stream = src.blocks()       # sharded receiver splits on upload
        elif use_ss:
            import numpy as _np
            from .io import formats as _fmts
            if ss.input_kind == 'CS16':
                # quantize live samples to CS16 on the ingest thread:
                # half the bytes over the interconnect (SDR sources are
                # natively int16 anyway; see io/soapy_input.py)
                raw_iter = (_np.frombuffer(_fmts.serialize(b, 'CS16'),
                                           _np.uint8)
                            for b in src.blocks())
            else:
                raw_iter = (b.view(_np.uint8) for b in src.blocks())
            stream = ingest.superstep_stream(self.receiver, raw_iter)
        else:
            stream = ingest.uploaded_stream(src.blocks(), 'CF32',
                                            packed=packed)
        try:
            for xd in stream:
                if self._stop.is_set():
                    break
                if use_ss:
                    self.handle_events(self.receiver.process_packed(xd))
                else:
                    self.handle_events(self.receiver.process(xd))
                over = src.overruns
                if over != last_over:
                    print(f'input: ring overrun, {over - last_over} samples '
                          'dropped', file=sys.stderr)
                    if self.statsd is not None:
                        self.statsd.increment('input.overruns',
                                              over - last_over)
                    last_over = over
        finally:
            self.last_ingest_overruns = src.overruns
            src.stop()
            self._stop.set()
        return 0

    def run_stream_raw(self, raw_iter, sample_format: str | None = None) -> int:
        """Decode an iterator of RAW sample buffers in the SDR's native
        width (bytes / uint8 arrays; CS16 = 4 bytes per sample).

        This is the high-rate live path: no host-side float conversion at
        all -- raw bytes ride a ring, are re-chunked to the superstep
        cadence, and convert on device inside the fused program.  The
        ring reuses the lock-free SampleRing with 8-byte slots (the raw
        stream is VIEWED as complex64 for storage only; the bytes are
        never interpreted until the device converts them)."""
        import numpy as _np
        from .io import formats, ingest
        fmt = (sample_format or self.cfg.sample_format).upper()
        ss = getattr(self.receiver, 'superstep', None)
        if ss is None or ss.input_kind != fmt:
            # fall back: convert on host and use the generic stream path
            return self.run_stream(
                (formats.convert(raw, fmt) for raw in raw_iter))
        self._start_nf_stats()
        chunk_bytes = self.receiver.raw_chunk_bytes
        assert chunk_bytes % 8 == 0
        slots = chunk_bytes // 8          # 8-byte ring slots
        bps = formats.bytes_per_sample(fmt)

        def as_slots(raw):
            b = _np.frombuffer(raw, _np.uint8) if isinstance(
                raw, (bytes, bytearray, memoryview)) else \
                _np.asarray(raw, _np.uint8)
            return b[:len(b) - len(b) % 8].view(_np.complex64)

        src = ingest.StreamIngest((as_slots(r) for r in raw_iter), slots,
                                  ring_capacity=4 * slots, stop=self._stop)
        stream = ingest.superstep_stream(
            self.receiver, (b.view(_np.uint8) for b in src.blocks()))
        last_over = 0
        try:
            for pk in stream:
                if self._stop.is_set():
                    break
                self.handle_events(self.receiver.process_packed(pk))
                over = src.overruns
                if over != last_over:
                    n = (over - last_over) * 8 // bps
                    print(f'input: ring overrun, {n} samples dropped',
                          file=sys.stderr)
                    if self.statsd is not None:
                        self.statsd.increment('input.overruns', n)
                    last_over = over
        finally:
            self.last_ingest_overruns = src.overruns * 8 // bps
            src.stop()
            self._stop.set()
        return 0

    def stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        self.outputs.shutdown()

    # -- noise floor stats thread (hfdl.c:1082-1105) --

    def _start_nf_stats(self) -> None:
        if self.statsd is None or self.cfg.nf_stats_interval <= 0:
            return

        def loop():
            while not self._stop.wait(self.cfg.nf_stats_interval):
                nf = np.asarray(self.receiver.bank.tracker_state.noise_floor)
                for i, freq in enumerate(self.cfg.frequencies):
                    db = level_to_db(float(nf[i]))
                    if db <= 0.0:
                        # gauges are non-negative ints: tenths of -dBFS
                        self.statsd.set_per_channel(
                            freq, 'noise_floor', round(abs(db) * 10))

        self._nf_thread = threading.Thread(target=loop, daemon=True,
                                           name='nf-stats')
        self._nf_thread.start()
