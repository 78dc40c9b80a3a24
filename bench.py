#!/usr/bin/env python
"""Benchmark: max MEASURED real-time HFDL channel capacity on one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Measurements run in subprocesses with a timeout:

1. **Max-real-time-channels search** (the headline): the FULL pipeline
   -- synthesized wideband capture with real frame traffic
   (dumphfdl_tpu/loadgen.py), decoded through raw-width upload, device
   channelizer, demod, frame backend (Viterbi), protocol stack, text
   formatter, output thread; identical code to `dumphfdl-tpu --iq-file`
   -- is measured at increasing channel counts.  The headline value is
   the largest configuration whose measured rt_factor is >= 1.0 (never an
   extrapolation from a sub-real-time run).  Each point runs warm passes
   first, so compilation is not timed.
2. **Demod-only**: channel-samples/s through the fused demod step alone
   on noise input, reported as `demod_only_channels`.

Every result names the device it ran on.  A child that fails makes the
whole bench fail (non-zero exit, the reason in `failures`); there is no
fallback to another platform.

Baseline: the reference decoder sustains ~2 Msps of wideband input on
~3 CPU cores (Odroid XU4, /root/reference/README.md:969), i.e. about 12
active HFDL channels (two ~0.75 MHz subbands with ~6 assigned channels
each).  vs_baseline = channels / 12.
"""

import json
import os
import subprocess
import sys

BASELINE_CHANNELS = 12.0

_PRELUDE = r'''
import os, sys, time, json
import numpy as np, jax, jax.numpy as jnp
from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
platform = jax.devices()[0].platform
print(f'# devices: {jax.devices()}', file=sys.stderr, flush=True)
'''

_DEMOD_CHILD = _PRELUDE + r'''
from dumphfdl_tpu.dsp.channel import ChannelBank
from dumphfdl_tpu.utils.prefetch import device_prefetch

num_channels = int(os.environ.get('BENCH_CHANNELS', '1024'))
# 1 s blocks of 5400-sps samples
block = 5400
bank = ChannelBank(num_channels, pipeline_events=True)  # production path
rng = np.random.default_rng(0)
# distinct blocks, streamed like the real-time path: int16-packed upload
# (CS16-equivalent precision) overlapped with compute via prefetch
blocks = [(rng.standard_normal((num_channels, block))
           + 1j * rng.standard_normal((num_channels, block))
           ).astype(np.complex64) * 0.1 for _ in range(4)]
t0 = time.time()
bank.process(next(iter(device_prefetch([blocks[0]]))))     # compile
print(f'# compile+first block: {time.time()-t0:.1f}s', file=sys.stderr, flush=True)
bank.process(next(iter(device_prefetch([blocks[1]]))))     # warm
n = 24
stream = (blocks[i % len(blocks)] for i in range(n))
t0 = time.time()
for xd in device_prefetch(stream):
    bank.process(xd)
wall = time.time() - t0
chan_sps = n * num_channels * block / wall
print(json.dumps({'platform': platform, 'chan_sps': chan_sps,
                  'channels': num_channels}), flush=True)
'''

_E2E_CHILD = _PRELUDE + r'''
from dumphfdl_tpu import loadgen
from dumphfdl_tpu.io.formats import bytes_per_sample
from dumphfdl_tpu.app import AppConfig, HfdlApp
from dumphfdl_tpu.io.outputs import OutputManager, OutputSpec
from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
from dumphfdl_tpu.protocol.enrichment import AcCache, SysTable

FS = int(os.environ.get('BENCH_E2E_FS', '2160000'))        # 400 x 5400
NCH = int(os.environ.get('BENCH_E2E_CHANNELS', '256'))
FMT = os.environ.get('BENCH_E2E_FMT', 'CS16').upper()
PASSES = int(os.environ.get('BENCH_E2E_PASSES', '4'))
WARM = int(os.environ.get('BENCH_E2E_WARM', '3'))
freqs = loadgen.channel_grid(NCH, FS)
t0 = time.time()
raw, emit_by_chan = loadgen.make_capture(freqs, FS, FMT)
print(f'# capture: {len(raw) / bytes_per_sample(FMT) / FS:.2f}s x '
      f'{FS/1e6:.3f} Msps ({FMT}), {len(emit_by_chan)} frames, '
      f'synth {time.time()-t0:.1f}s', file=sys.stderr, flush=True)

ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                      ac_data=None, options=ProtocolOptions())
outputs = OutputManager(ctx, hwm=0)
outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
# 3 s demod blocks amortize the fixed per-block dispatch and readback at
# the cost of event latency.  When the geometry aligns the receiver
# upgrades to the superstep (ONE dispatch per ~2 s super-block,
# dsp/superstep.py).
BLOCK = int(os.environ.get('BENCH_DEMOD_BLOCK', '16200'))
cfg = AppConfig(frequencies=freqs, sample_rate=FS,
                centerfreq=loadgen.CENTER, demod_block_len=BLOCK,
                sample_format=FMT)
app = HfdlApp(cfg, ctx, outputs)
ss = app.receiver.superstep
# EXACT ledger: after the timed passes the receiver is flushed, so
# in-flight tails cannot masquerade as losses: the gate is zero missing
# (channel, pass) cells, exactly.
ledger = loadgen.Ledger(emit_by_chan,
                        ss.delay_symbols if ss is not None else 0)

t0 = time.time()
for w in range(WARM):       # compile + warm every program variant
    loadgen.run_pass(app, raw, FMT, ledger)
print(f'# compile+{WARM} warm passes: {time.time()-t0:.1f}s, '
      f'{app.frames_decoded} frames', file=sys.stderr, flush=True)
t0 = time.time()
secs = 0.0
for _ in range(PASSES):
    secs += loadgen.run_pass(app, raw, FMT, ledger)
wall = time.time() - t0
rt = secs / wall
app.handle_events(ledger.record(app.receiver.flush()))
led = ledger.settle()
if led['frames_lost']:
    print(f"# LOST midstream: {led['lost_cells']}", file=sys.stderr,
          flush=True)
print(json.dumps({'platform': platform,
                  'device_kind': jax.devices()[0].device_kind,
                  'e2e_rt_channels': NCH * rt,
                  'wideband_sps': FS * rt,
                  'rt_factor': rt,
                  'channels': NCH,
                  'sample_format': FMT,
                  'superstep': ss is not None,
                  'frames_ok': led['frames_ok'],
                  'frames_expected_total': led['frames_expected_total'],
                  'frames_lost_midstream': led['frames_lost'],
                  'frames_junk': led['frames_junk'],
                  'frames_other': led['frames_other'],
                  'frames_duplicate': led['frames_duplicate'],
                  'coverage_ok': not led['frames_lost'],
                  'frames_decoded': app.frames_decoded,
                  'frames_junk_app': app.frames_junk}),
      flush=True)
outputs.shutdown()
'''


FAILURES: dict[str, str] = {}     # child label -> why it produced no metric


def run_child(code: str, key: str, timeout: float,
              extra_env: dict | None = None) -> dict | None:
    """Run a measurement child; on failure, record WHY in FAILURES."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.abspath(__file__))
    env['PYTHONPATH'] = ':'.join(
        p for p in [repo, env.get('PYTHONPATH', '')] if p)
    env.update(extra_env or {})
    label = key + ''.join(f':{v}' for v in (extra_env or {}).values())
    try:
        out = subprocess.run([sys.executable, '-c', code],
                             capture_output=True, text=True,
                             timeout=timeout, env=env, cwd=repo)
    except subprocess.TimeoutExpired as te:
        part = te.stderr or b''
        if isinstance(part, bytes):
            part = part.decode('utf-8', 'replace')
        tail = (part.strip().splitlines() or ['no output'])[-1]
        FAILURES[label] = (f'timeout after {timeout:.0f}s '
                           f'(last: {tail[-160:]})')
        return None
    sys.stderr.write(out.stderr[-2000:])
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if key in obj:
            return obj
    tail = (out.stderr.strip().splitlines() or ['no output'])[-1]
    FAILURES[label] = f'exit {out.returncode}: {tail[-200:]}'
    return None


def main() -> int:
    # measure the FULL pipeline at increasing channel counts, widening
    # the capture when the 3 kHz HFDL channel grid no longer fits (1024 ch
    # needs >= 3.07 MHz of spectrum); the 4096-channel rung rides CU8,
    # the RTL-SDR native 8-bit format the reference ingests too
    # (input-helpers.c:94-105)
    search = []
    for p_ in os.environ.get(
            'BENCH_SEARCH',
            '512@2160000,1024@3456000,2048@6912000,'
            '4096@13824000@CU8').split(','):
        parts = p_.split('@')
        search.append((int(parts[0]), int(parts[1]),
                       parts[2] if len(parts) > 2 else 'CS16'))

    points = []
    for nch, fs, fmt in search:
        # larger configs synthesize/compile longer; fewer warm passes
        # above 1024 ch keep the child inside its timeout
        r = run_child(_E2E_CHILD, 'e2e_rt_channels',
                      timeout=700 if nch <= 512 else 2100,
                      extra_env={'BENCH_E2E_CHANNELS': str(nch),
                                 'BENCH_E2E_FS': str(fs),
                                 'BENCH_E2E_FMT': fmt,
                                 'BENCH_E2E_WARM': '3' if nch <= 1024
                                 else '2'})
        if r is None:
            break
        points.append(r)
        if r['rt_factor'] < 1.0:
            break
    demod = run_child(_DEMOD_CHILD, 'chan_sps', timeout=480)

    if FAILURES or not points or demod is None:
        print(json.dumps({'metric': 'bench failed', 'value': 0,
                          'unit': 'channels', 'vs_baseline': 0.0,
                          'failures': FAILURES}))
        return 1

    best_rt = [p for p in points
               if p['rt_factor'] >= 1.0 and p.get('coverage_ok', True)]
    extras = {
        'device': {'platform': points[0]['platform'],
                   'kind': points[0]['device_kind']},
        'demod_only_channels': round(demod['chan_sps'] / 5400.0, 1),
        'demod_batch': demod['channels'],
        'search': [{'channels': p['channels'],
                    'rt_factor': round(p['rt_factor'], 2),
                    'msps': round(p['wideband_sps'] / p['rt_factor'] / 1e6,
                                  3),
                    'fmt': p.get('sample_format', 'CS16')}
                   for p in points],
    }
    # decode self-verification gates the headline: a point only counts
    # as real-time if every emitting channel decoded every pass
    if best_rt:
        best = max(best_rt, key=lambda p: p['channels'])
        value = best['channels']
        headline = ('max MEASURED real-time HFDL channels, FULL pipeline: '
                    f"wideband {best.get('sample_format', 'CS16')} capture "
                    '-> upload -> channelizer -> demod -> Viterbi -> '
                    'protocol -> text output '
                    f"(1 {best['device_kind']}, rt_factor "
                    f"{best['rt_factor']:.2f} at {best['channels']} ch @ "
                    f"{best['wideband_sps']/best['rt_factor']/1e6:.3f} Msps)")
    else:
        best = points[-1]
        value = round(best['channels'] * best['rt_factor'], 1)
        headline = ('real-time HFDL channel equivalent, FULL pipeline, '
                    f"NOT real-time (rt_factor {best['rt_factor']:.2f} at "
                    f"{best['channels']} ch @ "
                    f"{best['wideband_sps']/best['rt_factor']/1e6:.3f} Msps)")
    extras['wideband_msps'] = round(best['wideband_sps'] / 1e6, 3)
    extras['rt_factor'] = round(best['rt_factor'], 2)
    for f in ('frames_ok', 'frames_expected_total', 'frames_lost_midstream',
              'frames_junk', 'frames_other', 'frames_duplicate',
              'coverage_ok', 'superstep'):
        if f in best:
            extras[f] = best[f]
    print(json.dumps({
        'metric': headline,
        'value': value,
        'unit': 'channels',
        'vs_baseline': round(value / BASELINE_CHANNELS, 2),
        **extras,
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
