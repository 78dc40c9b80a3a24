"""Decoupled ingest pipeline: raw-width uploads, file chunking, stream ring.

The on-device converters must be bit-exact with the host converters
(io/formats.py, mirroring /root/reference/src/input-helpers.c:10-78) so
the prefetching live path decodes identically to the offline path.
"""

import io as io_mod
import threading
import time

import numpy as np
import pytest

from dumphfdl_tpu.io import formats, ingest


@pytest.mark.parametrize('fmt', ['CU8', 'CS16', 'CF32'])
def test_upload_matches_host_convert(fmt):
    """Device conversion matches the host converters to 1 ULP (XLA
    rewrites constant division into reciprocal multiply; CF32 is exact)."""
    rng = np.random.default_rng(7)
    n = 1000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64) * 0.3
    raw = formats.serialize(x, fmt)
    want = formats.convert(raw, fmt)
    got = np.asarray(ingest.upload(raw, fmt))
    assert got.dtype == np.complex64
    if fmt == 'CF32':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-9)


def test_upload_cs16_extremes():
    raw = np.asarray([-32768, 32767, 0, -1, 1, -32768], np.int16).tobytes()
    want = formats.convert(raw, 'CS16')
    got = np.asarray(ingest.upload(raw, 'CS16'))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-9)


def test_upload_cu8_odd_sample_count():
    raw = bytes(range(10))                      # 5 samples, not a mult of 4 B
    want = formats.convert(raw, 'CU8')
    got = np.asarray(ingest.upload(raw, 'CU8'))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-9)


class ShortReadFile:
    """File-like object that returns at most 7 bytes per read."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> bytes:
        take = min(n, 7, len(self._data) - self._pos)
        out = self._data[self._pos:self._pos + take]
        self._pos += take
        return out


def test_file_chunks_accumulates_short_reads():
    data = bytes(range(256)) * 4                # 1024 bytes
    chunks = list(ingest.file_chunks(ShortReadFile(data), 'CS16', 256))
    assert [len(c) for c in chunks] == [256, 256, 256, 256]
    assert b''.join(c.tobytes() for c in chunks) == data


def test_file_chunks_trims_trailing_partial_sample():
    data = bytes(100)                           # 25 CS16 samples + 1 odd byte
    chunks = list(ingest.file_chunks(io_mod.BytesIO(data + b'\x01'), 'CS16', 64))
    total = sum(len(c) for c in chunks)
    assert total == 100                         # the odd byte is dropped


def test_uploaded_stream_order_and_error():
    blocks = [np.full(64, i, np.complex64) for i in range(5)]

    def bad():
        yield from blocks
        raise RuntimeError('source died')

    it = ingest.uploaded_stream(iter(blocks), 'CF32', depth=2)
    vals = [float(np.asarray(b)[0].real) for b in it]
    assert vals == [0.0, 1.0, 2.0, 3.0, 4.0]
    it = ingest.uploaded_stream(bad(), 'CF32', depth=2)
    with pytest.raises(RuntimeError, match='source died'):
        for _ in it:
            pass


def test_stream_ingest_blocks_and_tail_padding():
    chunks = [np.arange(i * 100, i * 100 + 100).astype(np.complex64)
              for i in range(5)]                # 500 samples total
    src = ingest.StreamIngest(iter(chunks), block_samples=128)
    out = list(src.blocks())
    assert [len(b) for b in out] == [128, 128, 128, 128]
    flat = np.concatenate(out)
    np.testing.assert_array_equal(flat[:500].real, np.arange(500))
    np.testing.assert_array_equal(flat[500:], np.zeros(12, np.complex64))


def test_stream_ingest_error_propagates():
    def bad():
        yield np.zeros(10, np.complex64)
        raise ValueError('sdr gone')

    src = ingest.StreamIngest(bad(), block_samples=16)
    with pytest.raises(ValueError, match='sdr gone'):
        list(src.blocks())


def test_stream_ingest_stop_event():
    stop = threading.Event()

    def endless():
        while True:
            yield np.zeros(64, np.complex64)
            time.sleep(0.001)

    src = ingest.StreamIngest(endless(), block_samples=64, stop=stop)
    it = src.blocks()
    next(it)
    stop.set()
    # must terminate (remaining buffered blocks then StopIteration)
    n = sum(1 for _ in it)
    assert n <= src.ring.overruns + 16


def test_run_file_decodes_via_ingest(tmp_path):
    """End-to-end: HfdlApp.run_file through the prefetching ingest path
    decodes the same frame as the direct receiver path, for a CS16 file
    (exercising the raw-width upload)."""
    from dumphfdl_tpu.app import AppConfig, HfdlApp
    from dumphfdl_tpu.dsp import modulator
    from dumphfdl_tpu.io.outputs import OutputManager
    from dumphfdl_tpu.protocol.runtime import (ProtocolContext,
                                               ProtocolOptions)
    from dumphfdl_tpu.protocol.enrichment import AcCache, SysTable

    fs = 36_000
    chan = 10_000_000
    rng = np.random.default_rng(11)
    pdu = modulator.make_test_mpdu(1, rng, icao=0x123456)
    wb = modulator.synthesize_wideband([(pdu, 1, chan)], fs=fs,
                                       centerfreq=chan, snr_db=30.0)
    path = tmp_path / 'capture.cs16'
    path.write_bytes(formats.serialize(wb, 'CS16'))

    ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                          ac_data=None, options=ProtocolOptions())
    outputs = OutputManager(ctx, hwm=0)
    cfg = AppConfig(frequencies=[chan], sample_rate=fs,
                    read_buffer_size=16_000, sample_format='CS16')
    app = HfdlApp(cfg, ctx, outputs)
    rc = app.run_file(str(path), 'CS16')
    assert rc == 0
    assert app.frames_decoded == 1
