#!/usr/bin/env python
"""Stage-level wall-clock profile of the full-pipeline bench config.

Answers "where does the real-time deficit live" (VERDICT r2 missing #1):
runs the exact BENCH e2e workload and times each stage in isolation --
upload, channelizer, channelizer+demod, full path -- plus an optional
jax.profiler trace of one full pass (--trace DIR).

Usage:  python extras/profile_e2e.py [--fs 1728000] [--channels 128]
                                     [--passes 2] [--trace /tmp/xprof]
                                     [--cpu]
"""

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fs', type=int, default=1_728_000)
    ap.add_argument('--channels', type=int, default=128)
    ap.add_argument('--passes', type=int, default=2)
    ap.add_argument('--trace', default=None)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()
    if args.cpu:
        os.environ['JAX_PLATFORMS'] = 'cpu'

    import numpy as np
    import jax

    from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from dumphfdl_tpu import constants as C
    from dumphfdl_tpu.dsp import modulator
    from dumphfdl_tpu.io import formats as fmts, ingest
    from dumphfdl_tpu.app import AppConfig, HfdlApp
    from dumphfdl_tpu.io.outputs import OutputManager, OutputSpec
    from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
    from dumphfdl_tpu.protocol.enrichment import AcCache, SysTable

    FS, NCH = args.fs, args.channels
    CENTER = 10_000_000
    SPACING = max(3000, min(8000, (FS - 20000) // max(NCH, 1)))
    freqs = [CENTER + (i - NCH // 2) * SPACING for i in range(NCH)]
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    rng = np.random.default_rng(0)
    emissions = []
    for k, ci in enumerate(range(0, NCH, max(1, NCH // 16))):
        mode = single_slot[k % len(single_slot)]
        emissions.append((modulator.make_test_mpdu(mode, rng), mode,
                          freqs[ci]))
    wb = modulator.synthesize_wideband_fft(emissions, fs=FS,
                                           centerfreq=CENTER, snr_db=30.0)
    raw = fmts.serialize(wb, 'CS16')
    duration = len(wb) / FS
    print(f'# capture {duration:.2f}s @ {FS/1e6:.3f} Msps, {NCH} ch, '
          f'{len(emissions)} frames; devices={jax.devices()}', flush=True)

    def raw_stream():
        return ingest.file_chunks(io.BytesIO(raw), 'CS16', 1 << 20)

    def timed(label, fn, passes=args.passes):
        fn()                      # compile + warm
        t0 = time.time()
        for _ in range(passes):
            fn()
        dt = (time.time() - t0) / passes
        print(f'{label:<42} {dt:7.2f} s/pass   rt={duration/dt:5.2f}x',
              flush=True)
        return dt

    # 1. ingest+upload only
    def upload_only():
        last = None
        for xd in ingest.uploaded_stream(raw_stream(), 'CS16'):
            last = xd
        jax.block_until_ready(last)
    timed('upload (read+convert+H2D)', upload_only)

    # 2. channelizer only (fresh each pass to reset ring state is costly;
    #    reuse one and let state carry -- steady-state behavior)
    from dumphfdl_tpu.dsp.frontend import Channelizer
    cz = Channelizer(FS, CENTER, freqs)
    def chan_only():
        last = None
        for xd in ingest.uploaded_stream(raw_stream(), 'CS16'):
            for c in cz.process_device(xd):
                last = c
        if last is not None:
            jax.block_until_ready(last)
    timed('upload + channelizer', chan_only)

    # 3. full DSP (channelizer + demod), no protocol/output
    from dumphfdl_tpu.dsp.receiver import WidebandReceiver
    rx = WidebandReceiver(FS, CENTER, freqs)
    def dsp_only():
        n = 0
        for xd in ingest.uploaded_stream(raw_stream(), 'CS16'):
            n += len(rx.process(xd))
        return n
    timed('upload + channelizer + demod + events', dsp_only)

    # 4. full app path
    ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                          ac_data=None, options=ProtocolOptions())
    outputs = OutputManager(ctx, hwm=0)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    cfg = AppConfig(frequencies=freqs, sample_rate=FS, centerfreq=CENTER)
    app = HfdlApp(cfg, ctx, outputs)
    def full():
        for xd in ingest.uploaded_stream(raw_stream(), 'CS16'):
            app.handle_events(app.receiver.process(xd))
    timed('FULL (…+ protocol + text output)', full)
    print(f'# frames decoded: {app.frames_decoded}')

    if args.trace:
        with jax.profiler.trace(args.trace):
            full()
        print(f'# trace written to {args.trace}')
    outputs.shutdown()


if __name__ == '__main__':
    main()
