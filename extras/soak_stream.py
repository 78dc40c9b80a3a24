#!/usr/bin/env python
"""Live-path endurance soak: real-time-paced streaming decode (VERDICT r3 #9).

Feeds HfdlApp.run_stream from a synthetic source that releases wideband
chunks at REAL TIME (like an SDR would; the reference's analogue is the
SoapySDR rx thread + ring, input-helpers.c:80-92) for several minutes at
high channel count, and records:

  * input ring overruns (must be 0 -- the decoder kept up),
  * end-to-end event latency (frame-end on air -> event handled), p50 /
    p95 / max over the run,
  * RSS at start/end (memory stability),
  * decoded-frame correctness vs the emitted schedule.

Writes SOAK_STREAM.json at the repo root and prints it.

Usage:  python extras/soak_stream.py            # 256 ch, 120 s
        SOAK_STREAM_CHANNELS=1024 SOAK_STREAM_SECONDS=300 ...
"""

import json
import os
import resource
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np            # noqa: E402


def main() -> int:
    from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from dumphfdl_tpu import constants as C
    from dumphfdl_tpu.app import AppConfig, HfdlApp
    from dumphfdl_tpu.dsp import modulator
    from dumphfdl_tpu.io.outputs import OutputManager, OutputSpec
    from dumphfdl_tpu.protocol.runtime import ProtocolContext

    nch = int(os.environ.get('SOAK_STREAM_CHANNELS', '256'))
    seconds = float(os.environ.get('SOAK_STREAM_SECONDS', '120'))
    fs = int(os.environ.get('SOAK_STREAM_FS',
                            str(max(2_160_000, nch * 3375))))
    center = 10_000_000
    spacing = max(3000, min(8000, (fs - 20000) // max(nch, 1)))
    freqs = [center + (i - nch // 2) * spacing for i in range(nch)]

    # a looping capture with real frames on 16 channels
    rng = np.random.default_rng(0)
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    emissions, emit_by_chan = [], {}
    for k, ci in enumerate(range(0, nch, max(1, nch // 16))):
        mode = single_slot[k % len(single_slot)]
        pdu = modulator.make_test_mpdu(mode, rng)
        emissions.append((pdu, mode, freqs[ci]))
        emit_by_chan[ci] = pdu
    print(f'# synthesizing {len(emissions)}-frame capture at '
          f'{fs / 1e6:.3f} Msps x {nch} ch', file=sys.stderr, flush=True)
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs,
                                           centerfreq=center, snr_db=30.0)
    loop_len = len(wb)
    fmt = os.environ.get('SOAK_STREAM_FMT', 'CF32').upper()
    from dumphfdl_tpu.io import formats as fmts_mod
    wb_raw = np.frombuffer(fmts_mod.serialize(wb, fmt), np.uint8) \
        if fmt != 'CF32' else None

    ctx = ProtocolContext()
    outputs = OutputManager(ctx, hwm=1000)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    cs_cfg = 1 << int(np.ceil(np.log2(max(
        int(fs * float(os.environ.get('SOAK_STREAM_CHUNK_S', '0.75'))),
        32768))))
    cfg = AppConfig(frequencies=freqs, sample_rate=fs, centerfreq=center,
                    demod_block_len=int(os.environ.get('SOAK_STREAM_BLOCK',
                                                       '16200')),
                    sample_format=os.environ.get('SOAK_STREAM_FMT', 'CF32'),
                    stream_chunk_samples=cs_cfg)
    app = HfdlApp(cfg, ctx, outputs)
    ss = app.receiver.superstep
    print(f'# superstep: {ss is not None}', file=sys.stderr, flush=True)

    # real-time paced source: each chunk is released no earlier than its
    # stream time (chunk k covers samples [k*cs, (k+1)*cs))
    cs = cfg.stream_chunk_samples
    t_start = [None]
    warm_samples = [0]

    def source():
        # raw mode paces pre-serialized SDR-native byte chunks (zero
        # per-chunk conversion work, like a real SDR driver buffer)
        bps = fmts_mod.bytes_per_sample(fmt)
        k = 0
        while True:
            if wb_raw is not None:
                csb = cs * bps
                offb = (k * csb) % len(wb_raw)
                chunk = np.concatenate([
                    wb_raw[offb:offb + csb],
                    wb_raw[:max(0, offb + csb - len(wb_raw))]])[:csb]
            else:
                off = (k * cs) % loop_len
                chunk = np.concatenate([wb[off:off + cs],
                                        wb[:max(0, off + cs - loop_len)]])[:cs]
            if t_start[0] is None:
                t_start[0] = time.time()
            due = t_start[0] + k * cs / fs
            delay = due - time.time()
            if delay > 0:
                time.sleep(delay)
            if time.time() - t_start[0] > seconds:
                return
            yield chunk
            k += 1

    latencies = []
    decoded_ok = [0]
    junk = [0]
    orig = app.handle_events

    def wrapped(events):
        now = time.time()
        for ev in events:
            if ev.pdu is None:
                continue
            if not ev.fcs_ok:
                junk[0] += 1
                continue
            exp = emit_by_chan.get(ev.channel)
            if exp is not None and ev.pdu[:len(exp)] == exp:
                decoded_ok[0] += 1
            # frame END time on air (start + its mode's frame length);
            # start_symbol counts from stream start INCLUDING the warm-up
            # samples, which were not paced
            p = C.MODES[ev.mode]
            sym = ev.start_symbol - (ss.delay_symbols if ss is not None
                                     else 0)
            end_s = ((sym + p.frame_len_symbols) / C.SYMBOL_RATE
                     - warm_samples[0] / fs)
            if t_start[0] is not None and end_s > 0:
                latencies.append(now - (t_start[0] + end_s))
        orig(events)

    app.handle_events = wrapped
    app.stream_epoch = time.time()

    # compile + warm the whole chain BEFORE pacing starts, otherwise the
    # first real-time chunks pile up behind XLA compilation and the soak
    # measures compile time as overruns
    print('# warming (compile)...', file=sys.stderr, flush=True)
    # enough warm stream to run several full demod blocks (the demod
    # step only fires once a whole block of 5400-sps samples is
    # buffered; warming less would compile it mid-stream and overrun)
    warm_need = 3 * cfg.demod_block_len * (fs // C.INTERNAL_RATE + 1)         + 2 * fs
    k = 0
    if ss is not None:
        wbz = np.concatenate([wb, wb])
        while app.receiver.sample_clock < warm_need:
            off = (k * ss.plan.wb_chunk) % loop_len
            chunk = wbz[off:off + ss.plan.wb_chunk]
            app.handle_events(app.receiver.process_packed(
                ss.upload(np.ascontiguousarray(chunk).view(np.uint8))))
            k += 1
    else:
        while app.receiver.sample_clock < warm_need:
            off = (k * cs) % loop_len
            app.handle_events(app.receiver.process(wb[off:off + cs]))
            k += 1
    warm_samples[0] = app.receiver.sample_clock

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.time()
    if wb_raw is not None:
        app.run_stream_raw(source(), sample_format=fmt)
    else:
        app.run_stream(source())
    wall = time.time() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    lat = np.asarray(sorted(latencies)) if latencies else np.asarray([0.0])
    out = {
        'metric': 'live-path endurance: real-time paced stream',
        'mode': os.environ.get('SOAK_STREAM_LABEL',
                               'superstep' if ss is not None else
                               f'block={cfg.demod_block_len}'),
        'superstep': ss is not None,
        'demod_block_len': cfg.demod_block_len,
        'channels': nch, 'sample_rate': fs,
        'seconds': round(wall, 1),
        'input_overrun_samples': getattr(app, 'last_ingest_overruns', 0),
        'frames_ok': decoded_ok[0],
        'frames_junk': junk[0],
        'latency_s': {
            'p50': round(float(np.percentile(lat, 50)), 3),
            'p95': round(float(np.percentile(lat, 95)), 3),
            'max': round(float(lat.max()), 3),
            'n': len(latencies),
        },
        'rss_start_kb': rss0, 'rss_end_kb': rss1,
        'platform': __import__('jax').devices()[0].platform,
    }
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, os.environ.get('SOAK_STREAM_OUT',
                                             'SOAK_STREAM.json'))
    if os.environ.get('SOAK_STREAM_APPEND') and os.path.exists(path):
        with open(path) as fh:
            prev = json.load(fh)
        entries = prev if isinstance(prev, list) else [prev]
        entries.append(out)
    else:
        entries = [out]
    with open(path, 'w') as fh:
        json.dump(entries if len(entries) > 1 else out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
