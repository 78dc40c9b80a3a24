"""Synthetic wideband traffic and the exact frame ledger, for benchmarks.

The traffic: N channels on a dense grid around 10 MHz, with a single-slot
frame (cycling through the single-slot modes) on every N//16-th channel
at 30 dB SNR, synthesized as one wideband capture in a raw SDR format.

The ledger: every decoded frame is classified against the emitted set
and mapped to the pass of the capture it came from via the tracker's
symbol clock, so after the passes and a flush every (emitting channel,
pass) cell must hold exactly one FCS-good decode.
"""

from __future__ import annotations

import io

import numpy as np

from . import constants as C
from .dsp import modulator
from .io import formats, ingest

CENTER = 10_000_000


def channel_grid(nch: int, fs: int, center: int = CENTER) -> list[int]:
    """nch channel frequencies (Hz), 3-8 kHz apart, inside fs."""
    spacing = max(3000, min(8000, (fs - 20000) // max(nch, 1)))
    return [center + (i - nch // 2) * spacing for i in range(nch)]


def make_capture(freqs: list[int], fs: int, fmt: str, seed: int = 0,
                 center: int = CENTER):
    """-> (raw capture bytes, {channel index: emitted PDU})."""
    nch = len(freqs)
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    rng = np.random.default_rng(seed)
    emissions, emit_by_chan = [], {}
    for k, ci in enumerate(range(0, nch, max(1, nch // 16))):
        mode = single_slot[k % len(single_slot)]
        pdu = modulator.make_test_mpdu(mode, rng)
        emissions.append((pdu, mode, freqs[ci]))
        emit_by_chan[ci] = pdu
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs, centerfreq=center,
                                           snr_db=30.0)
    return formats.serialize(wb, fmt), emit_by_chan


class Ledger:
    """Per-(channel, pass) decode accounting of one synthetic capture."""

    def __init__(self, emit_by_chan: dict, sym_offset: int = 0):
        self.emit_by_chan = emit_by_chan
        self.sym_offset = sym_offset      # superstep resampler delay
        self.cells: dict = {}             # (chan, pass) -> decode count
        self.junk = 0
        self.other = 0
        self.pass_symbols = [0.0]         # cumulative symbol clock at pass ends

    def record(self, events):
        for ev in events:
            if ev.pdu is None:
                continue
            if not ev.fcs_ok:
                self.junk += 1
                continue
            exp = self.emit_by_chan.get(ev.channel)
            if exp is not None and ev.pdu[:len(exp)] == exp:
                s = ev.start_symbol - self.sym_offset
                p = next((i for i, e in enumerate(self.pass_symbols[1:])
                          if s < e), len(self.pass_symbols) - 1)
                key = (ev.channel, p)
                self.cells[key] = self.cells.get(key, 0) + 1
            else:
                self.other += 1
        return events

    def end_pass(self, n_symbols: float) -> None:
        self.pass_symbols.append(self.pass_symbols[-1] + n_symbols)

    def settle(self) -> dict:
        passes = len(self.pass_symbols) - 1
        missing = [(ci, p) for ci in self.emit_by_chan for p in range(passes)
                   if (ci, p) not in self.cells]
        return {'frames_ok': sum(self.cells.values()),
                'frames_expected_total': passes * len(self.emit_by_chan),
                'frames_lost': len(missing),
                'lost_cells': missing[:20],
                'frames_duplicate': sum(n - 1 for n in self.cells.values()
                                        if n > 1),
                'frames_junk': self.junk,
                'frames_other': self.other}


def run_pass(app, raw: bytes, fmt: str, ledger: Ledger,
             read_chunk: int = 1 << 23) -> float:
    """Decode the capture once through the app's ingest loop (superstep
    or multi-dispatch, as the receiver chose); returns the stream seconds
    processed, padding included."""
    rx = app.receiver
    ss = getattr(rx, 'superstep', None)
    fh = io.BytesIO(raw)
    if ss is not None:
        n_sym = 0
        for pk in ingest.superstep_stream(
                rx, ingest.file_chunks(fh, fmt, rx.raw_chunk_bytes,
                                       pad_final=True)):
            app.handle_events(ledger.record(rx.process_packed(pk)))
            n_sym += ss.plan.symbols
    else:
        for xd in ingest.uploaded_stream(
                ingest.file_chunks(fh, fmt, read_chunk), fmt):
            app.handle_events(ledger.record(rx.process(xd)))
        n_sym = len(raw) / formats.bytes_per_sample(fmt) / app.cfg.sample_rate \
            * C.SYMBOL_RATE
    ledger.end_pass(n_sym)
    return n_sym / C.SYMBOL_RATE
