#!/usr/bin/env python
"""GPU smoke test: the HFDL decode path end to end on the card.

Runs in ONE process through the entry points a user calls, and fails
loudly.  Phases, in order, on one GPU:

  a. golden capture through ``cli.main`` (tests/golden): the decoded
     frames must equal the manifest's frames exactly;
  b. 1024 channels at 3.456 Msps CS16 on the superstep path, synthetic
     traffic (dumphfdl_tpu/loadgen.py): exact per-(channel, pass) ledger,
     real-time factor;
  c. the same traffic at 512 channels, 2.16 Msps: the non-superstep fused
     path, same ledger;
  d. the Triton tracker kernel against the ``lax.scan`` oracle at 1024
     channels for one super-block of symbols, on frames and on noise,
     with both device times.

``--four-cards`` runs only phase e: the phase-c capture decoded in one
process through the auto-sharded ChannelBank over all cards, through
``--mesh 2x2``, and on card 0 alone; the three frame sets must agree.

Prints the card's name and power limit (nvidia-smi), the JAX version,
per-phase wall and compile times and decode counts.  The last line is
one JSON object: ``{"ok": true, "device": {...}}`` when every phase
passed.  Without a GPU, or outside a checkout of this repository, it
prints ``"ok": false`` and exits non-zero at once.

Usage: python chip_smoke.py [--four-cards]
       (CHIP_SMOKE_OUT=DIR also writes DIR/chip_smoke.json)
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent


class PhaseFailed(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


_COMPILE_S = [0.0]


def _on_duration(event: str, duration: float, **_) -> None:
    if event.startswith('/jax/core/compile/'):
        _COMPILE_S[0] += duration


class Phase:
    """Wall time and compile time (JAX's own compile events) of a phase."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _COMPILE_S[0]
        log(f'== phase {self.name}')
        return self

    def __exit__(self, *exc):
        log(f'== phase {self.name}: wall {time.perf_counter() - self.t0:.3f} s, '
            f'compile {_COMPILE_S[0] - self.c0:.3f} s')
        return False


def _protocol_stack():
    from dumphfdl_tpu.io.outputs import OutputManager, OutputSpec
    from dumphfdl_tpu.protocol.enrichment import AcCache, SysTable
    from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
    ctx = ProtocolContext(systable=SysTable(str(REPO / 'etc' / 'systable.conf')),
                          ac_cache=AcCache(), ac_data=None,
                          options=ProtocolOptions())
    outputs = OutputManager(ctx, hwm=0)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    return ctx, outputs


# ---- phase a ---------------------------------------------------------------

def phase_golden() -> dict:
    from dumphfdl_tpu import cli
    from dumphfdl_tpu.app import HfdlApp
    gdir = REPO / 'tests' / 'golden'
    man = json.loads((gdir / 'manifest.json').read_text())
    got = []
    orig = HfdlApp.handle_events

    def recording(self, events):
        got.extend((e.channel, e.mode, e.pdu.hex(), e.fcs_ok)
                   for e in events if e.pdu is not None)
        return orig(self, events)

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / 'golden.json'
        HfdlApp.handle_events = recording
        try:
            rc = cli.main([
                '--iq-file', str(gdir / man['capture']),
                '--sample-format', man['format'],
                '--sample-rate', str(man['sample_rate']),
                '--centerfreq', str(man['centerfreq'] / 1000),
                '--system-table', str(REPO / 'etc' / 'systable.conf'),
                '--output', f'decoded:json:file:path={out}',
            ] + [str(f / 1000) for f in man['frequencies']])
        finally:
            HfdlApp.handle_events = orig
        lines = [json.loads(s) for s in out.read_text().splitlines() if s]
    expected = sorted((f['channel'], f['mode'], f['pdu_hex'], True)
                      for f in man['frames'])
    check(rc == 0, f'cli.main returned {rc}')
    check(sorted(got) == expected,
          f'golden frames differ: got {[(g[0], g[1], g[3]) for g in got]}')
    freqs = {ln['hfdl']['freq'] for ln in lines}
    check(freqs == set(man['frequencies']), f'JSON output freqs {freqs}')
    log(f'golden: {len(got)} frames decoded, all equal to the manifest')
    return {'frames': len(got)}


# ---- phases b, c -----------------------------------------------------------

def phase_wideband(nch: int, fs: int, block_len: int, *, superstep: bool,
                   fmt: str = 'CS16', warm: int = 1, passes: int = 3,
                   tracker: str | None = None,
                   fused_event_decode: int | None = None) -> dict:
    """Synthetic traffic through HfdlApp and the ingest loop; settles the
    exact ledger.  tracker / fused_event_decode override the platform's
    choice (for measurements); None keeps it."""
    from dumphfdl_tpu import loadgen
    from dumphfdl_tpu.app import AppConfig, HfdlApp
    freqs = loadgen.channel_grid(nch, fs)
    t0 = time.perf_counter()
    raw, emit = loadgen.make_capture(freqs, fs, fmt)
    stream_s = len(raw) / (4 if fmt == 'CS16' else 2) / fs
    log(f'capture: {nch} ch, {fs / 1e6:.3f} Msps {fmt}, {stream_s:.3f} s, '
        f'{len(emit)} frames, synthesized in {time.perf_counter() - t0:.3f} s')
    old = os.environ.get('DUMPHFDL_TRACKER')
    if tracker is not None:
        os.environ['DUMPHFDL_TRACKER'] = tracker
    try:
        ctx, outputs = _protocol_stack()
        app = HfdlApp(AppConfig(frequencies=freqs, sample_rate=fs,
                                centerfreq=loadgen.CENTER,
                                demod_block_len=block_len,
                                sample_format=fmt), ctx, outputs)
    finally:
        if old is None:
            os.environ.pop('DUMPHFDL_TRACKER', None)
        else:
            os.environ['DUMPHFDL_TRACKER'] = old
    rx = app.receiver
    if fused_event_decode is not None:
        rx.bank.fused_event_decode = fused_event_decode
    ss = rx.superstep
    if superstep:
        check(ss is not None, 'superstep path not engaged')
    else:
        check(ss is None and rx.fused, 'expected the fused non-superstep path '
              f'(superstep={ss is not None}, fused={rx.fused})')
    ledger = loadgen.Ledger(emit, ss.delay_symbols if ss is not None else 0)
    t0 = time.perf_counter()
    for _ in range(warm):
        loadgen.run_pass(app, raw, fmt, ledger)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    secs = sum(loadgen.run_pass(app, raw, fmt, ledger) for _ in range(passes))
    wall = time.perf_counter() - t0
    app.handle_events(ledger.record(rx.flush()))
    outputs.shutdown()
    led = ledger.settle()
    rt = secs / wall
    res = {'channels': nch, 'fs': fs, 'superstep': ss is not None,
           'fused': bool(rx.fused), 'tracker': rx.bank.tracker,
           'fused_event_decode': rx.bank.fused_event_decode,
           'blocks': (ss.blocks_done if ss is not None else None),
           'warm_s': warm_s, 'timed_wall_s': wall, 'stream_s': secs,
           'rt_factor': rt, **led}
    log(f'ledger: {led["frames_ok"]}/{led["frames_expected_total"]} ok, '
        f'{led["frames_lost"]} lost, {led["frames_duplicate"]} duplicate, '
        f'{led["frames_junk"]} junk, {led["frames_other"]} other; '
        f'tracker={res["tracker"]} fused_event_decode='
        f'{res["fused_event_decode"]}; real-time factor {rt:.4f} '
        f'({secs:.3f} stream s in {wall:.3f} s)')
    check(led['frames_lost'] == 0, f'lost cells {led["lost_cells"]}')
    check(led['frames_duplicate'] == 0, 'duplicate decodes')
    check(led['frames_other'] == 0, 'FCS-good frames that were not emitted')
    check(led['frames_ok'] == led['frames_expected_total'], 'ledger count')
    if ss is not None:
        check(ss.blocks_done >= 3, f'only {ss.blocks_done} super-blocks')
    return res


# ---- phase d ---------------------------------------------------------------

def _tracker_inputs(nch: int, steps: int, n_blocks: int, frames: bool,
                    seed: int = 7):
    """(nch, n_blocks*steps*3) baseband at 5400 sps: noise, plus (frames)
    a single-slot frame on every 16th channel starting in block 0 and
    ending in block 1.  Returns (x, {channel: pdu})."""
    import numpy as np
    from dumphfdl_tpu import constants as C
    from dumphfdl_tpu.dsp import modulator
    rng = np.random.default_rng(seed)
    n = n_blocks * steps * C.SPS
    x = ((rng.standard_normal((nch, n)) + 1j * rng.standard_normal((nch, n)))
         * 0.05).astype(np.complex64)
    pdus = {}
    if frames:
        single = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
        for k, ch in enumerate(range(0, nch, 16)):
            mode = single[k % len(single)]
            pdu = modulator.make_test_mpdu(mode, rng, icao=0x3C0000 + k)
            iq = modulator.synthesize_iq(
                modulator.frame_symbols(pdu, mode),
                imp=modulator.Impairments(cfo_hz=float(rng.uniform(-40, 40)),
                                          timing_offset=float(rng.uniform()),
                                          phase=float(rng.uniform(0, 6.28)),
                                          seed=k))
            off = 600 + 3 * int(rng.integers(0, 300))
            iq = iq[:n - off]
            x[ch, off:off + len(iq)] += iq
            pdus[ch] = pdu
    return x, pdus


def _device_time(fn, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())             # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _wrapped(a, b):
    import numpy as np
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


# float state of frame channels mid-frame: both trackers evaluate the same
# f32 formulas; they differ only in summation order (16-tap interpolator,
# 15-tap equalizer), in sin/cos/atan2 and division (libdevice vs XLA, a
# few ulp), so per step they differ by ~1e-7.  The timing, carrier and
# equalizer loops are contracting while locked, so the differences stay
# at that scale; 1e-3 absolute (phases compared modulo 2 pi) is three
# orders above it and still far below anything that moves a decision.
FLOAT_ATOL = 1e-3
INT_FIELDS = ('out_idx', 'fr_state', 'symbols_wanted', 'search_retries',
              'bitmask', 'mode', 'data_arity', 'cur_arity',
              'data_segments_left', 'eq_train_cnt', 't_idx', 'data_idx',
              'frame_counter', 'symbol_cnt', 'abs_symbol', 'frame_start_sym',
              'train_bad', 'train_total', 'nf_clk')
FLOAT_FIELDS = ('tau', 'rate', 'dphi', 'freq_err', 'signal_level',
                'frame_sym_cnt', 'noise_floor')


def phase_tracker(nch: int = 1024, steps: int | None = None,
                  tile: int | None = None, impl: str = 'kernel') -> dict:
    import jax.numpy as jnp
    import numpy as np
    from dumphfdl_tpu.dsp.channel import (ChannelBank, agc_block, agc_init,
                                          matched_filter)
    from dumphfdl_tpu.dsp.tracker import (EV_FIELDS, HALO, K_EVENTS,
                                          tracker_block, tracker_init)
    from dumphfdl_tpu.dsp.tracker_pallas import TILE, tracker_block_kernel
    if steps is None:          # one super-block of phase b (3.456 Msps)
        steps = 3584
    tile = TILE if tile is None else tile
    interpret = impl == 'interpret'
    res = {'channels': nch, 'steps': steps, 'tile': tile}

    def prep(x):
        _, y, lv = agc_block(agc_init(nch), jnp.asarray(x))
        mfe = jnp.concatenate([jnp.zeros((nch, HALO), jnp.complex64),
                               matched_filter(y)], axis=1)
        lve = jnp.concatenate([jnp.ones((nch, HALO), jnp.float32), lv],
                              axis=1)
        return mfe, lve

    for kind in ('frames', 'noise'):
        x, pdus = _tracker_inputs(nch, steps, 1, kind == 'frames')
        mfe, lve = prep(x)
        st = tracker_init(nch)
        s1, o1, ev1, c1 = tracker_block(st, mfe, lve, steps)
        s2, o2, ev2, c2 = tracker_block_kernel(st, mfe, lve, steps, tile=tile,
                                               interpret=interpret)
        t_scan = _device_time(lambda: tracker_block(st, mfe, lve, steps))
        t_kern = _device_time(lambda: tracker_block_kernel(
            st, mfe, lve, steps, tile=tile, interpret=interpret))
        res[f'{kind}_scan_s'] = t_scan
        res[f'{kind}_kernel_s'] = t_kern
        log(f'tracker {kind}: {nch} ch x {steps} symbols: scan {t_scan:.6f} s, '
            f'kernel {t_kern:.6f} s (tile {tile}), '
            f'speedup {t_scan / t_kern:.3f}x')
        ev1 = np.asarray(ev1).reshape(nch, K_EVENTS, EV_FIELDS)
        ev2 = np.asarray(ev2).reshape(nch, K_EVENTS, EV_FIELDS)
        if kind == 'frames':
            chans = np.asarray(sorted(pdus))
            # mid-frame at the block end: the full state must agree
            for f in INT_FIELDS:
                a = np.asarray(getattr(s1, f))[chans]
                b = np.asarray(getattr(s2, f))[chans]
                check(np.array_equal(a, b), f'int state {f} differs on '
                      f'{int((a != b).sum())} frame channels')
            worst = {}
            for f in FLOAT_FIELDS:
                worst[f] = float(np.max(np.abs(
                    np.asarray(getattr(s1, f), np.float64)[chans]
                    - np.asarray(getattr(s2, f), np.float64)[chans])))
            worst['phi'] = float(np.max(_wrapped(s1.phi, s2.phi)[chans]))
            worst['eq_taps'] = float(np.max(np.abs(
                np.asarray(s1.eq_taps)[chans] - np.asarray(s2.eq_taps)[chans])))
            worst['sym'] = float(np.max(np.abs(
                np.asarray(o1.sym)[:, chans] - np.asarray(o2.sym)[:, chans])))
            res['float_max_abs_diff'] = worst
            log(f'float state, frame channels: max |diff| {worst}')
            for f, v in worst.items():
                check(v <= FLOAT_ATOL, f'float {f} differs by {v}')
            check(np.array_equal(np.asarray(o1.is_data)[:, chans],
                                 np.asarray(o2.is_data)[:, chans]),
                  'is_data labels differ')
            check(np.array_equal(np.asarray(s1.window)[chans],
                                 np.asarray(s2.window)[chans]),
                  'bit window differs')
            check(np.array_equal(ev1[chans], ev2[chans]),
                  'event table differs on frame channels')
        else:
            # the gate sends idle tiles down the closed-form path: no
            # events, and the clocks of every channel agree
            check(not (ev1[:, :, 0] > 0.5).any()
                  and not (ev2[:, :, 0] > 0.5).any(), 'events on noise')
            for f in ('abs_symbol', 'out_idx', 'frame_counter'):
                check(np.array_equal(np.asarray(getattr(s1, f)),
                                     np.asarray(getattr(s2, f))),
                      f'{f} differs on noise')
            hunting = np.asarray(s1.fr_state) == np.asarray(s2.fr_state)
            res['noise_fr_state_equal'] = float(hunting.mean())
            log(f'noise: fr_state equal on {hunting.mean():.4f} of channels')

    # decoded frames through ChannelBank with each tracker, two blocks
    x, pdus = _tracker_inputs(nch, steps, 2, True)
    blk = steps * 3
    decoded = {}
    for impl_name in ('scan', impl):
        bank = ChannelBank(nch, auto_shard=False, tracker=impl_name,
                           fused_event_decode=0)
        evs = bank.process(x[:, :blk]) + bank.process(x[:, blk:])
        if impl_name != 'scan':
            from dumphfdl_tpu.dsp.channel import fused_collect
            table = bank._last_ev_table
            check(bool((np.asarray(table).reshape(nch, K_EVENTS, EV_FIELDS)
                        [:, :, 0] > 0.5).any()), 'no events in block 2')
            t_dec = _device_time(lambda: fused_collect(
                bank.symring, bank._ringmeta, table, 64))
            res['event_decode_s'] = t_dec
            log(f'event decode program (fused_collect, 64 slots, '
                f'{len(evs)} events): {t_dec:.6f} s')
        evs += bank.process(np.zeros((nch, blk), np.complex64))
        decoded[impl_name] = sorted((e.channel, e.mode, e.pdu.hex(), e.fcs_ok)
                                    for e in evs if e.pdu is not None)
    good = {(c, h) for c, _, h, ok in decoded['scan'] if ok}
    check(decoded['scan'] == decoded[impl],
          'decoded frames differ between scan and kernel')
    missing = [c for c, p in pdus.items() if (c, p.hex()) not in good]
    check(not missing, f'frames not decoded on channels {missing}')
    res['frames_decoded'] = len(decoded[impl])
    log(f'decoded frames: {len(decoded[impl])} identical between scan and '
        f'kernel (PDU bytes and FCS), {len(pdus)} emitted, all decoded')
    return res


# ---- phase e ---------------------------------------------------------------

def phase_four_cards(nch: int = 512, fs: int = 2_160_000,
                     block_len: int = 10752) -> dict:
    import jax
    from dumphfdl_tpu import loadgen
    from dumphfdl_tpu.app import AppConfig, HfdlApp
    check(len(jax.devices()) >= 4, f'{len(jax.devices())} devices')
    freqs = loadgen.channel_grid(nch, fs)
    raw, emit = loadgen.make_capture(freqs, fs, 'CS16')
    sets = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / 'capture.cs16'
        path.write_bytes(raw)
        for label, mesh, autoshard in (('auto-sharded', None, True),
                                       ('mesh 2x2', '2x2', True),
                                       ('card 0', None, False)):
            if autoshard:
                os.environ.pop('DUMPHFDL_NO_AUTOSHARD', None)
            else:
                os.environ['DUMPHFDL_NO_AUTOSHARD'] = '1'
            t0 = time.perf_counter()
            ctx, outputs = _protocol_stack()
            app = HfdlApp(AppConfig(frequencies=freqs, sample_rate=fs,
                                    centerfreq=loadgen.CENTER,
                                    demod_block_len=block_len,
                                    sample_format='CS16', mesh=mesh),
                          ctx, outputs)
            ledger = loadgen.Ledger(emit)
            orig = app.handle_events
            app.handle_events = lambda evs: orig(ledger.record(evs))
            ledger.end_pass(float('inf'))
            app.run_file(str(path), 'CS16')
            outputs.shutdown()
            led = ledger.settle()
            ndev = (app.receiver.bank.mesh.devices.size
                    if app.receiver.bank.mesh is not None else 1)
            sets[label] = sorted(ledger.cells)
            log(f'{label}: {ndev} devices, {led["frames_ok"]} frames ok, '
                f'{led["frames_lost"]} lost, {led["frames_junk"]} junk, '
                f'wall {time.perf_counter() - t0:.3f} s')
            check(led['frames_lost'] == 0 and led['frames_duplicate'] == 0,
                  f'{label}: ledger {led}')
        os.environ.pop('DUMPHFDL_NO_AUTOSHARD', None)
    check(sets['auto-sharded'] == sets['mesh 2x2'] == sets['card 0'],
          'frame sets differ between the three layouts')
    log(f'four cards: the three layouts decode the same {len(sets["card 0"])} '
        'frames')
    return {'frames': len(sets['card 0'])}


# ---- main ------------------------------------------------------------------

def fail(msg: str) -> int:
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    print(json.dumps({'ok': False, 'error': msg}), flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the four-card phase (e)')
    args = ap.parse_args(argv)
    try:
        import jax
        from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        return fail(f'cannot import the decoder: {e}')
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        return fail(f'no GPU: JAX found {devs[0].platform} devices')
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return fail(f'nvidia-smi: {e}')
    for line in smi.strip().splitlines():
        log(line)
    log(f'jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}')
    log(f'compile cache: {enable_compile_cache()}')
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    if args.four_cards:
        phases = [('e', phase_four_cards, {})]
    else:
        phases = [('a', phase_golden, {}),
                  ('b', phase_wideband, dict(nch=1024, fs=3_456_000,
                                             block_len=16200, superstep=True)),
                  ('c', phase_wideband, dict(nch=512, fs=2_160_000,
                                             block_len=10752,
                                             superstep=False)),
                  ('d', phase_tracker, {})]
    results = {}
    for name, fn, kw in phases:
        try:
            with Phase(name):
                results[name] = fn(**kw)
        except Exception as e:          # any failure fails the smoke
            import traceback
            traceback.print_exc()
            return fail(f'phase {name}: {type(e).__name__}: {e}')
    if os.environ.get('CHIP_SMOKE_OUT'):      # full results, as JSON
        out = pathlib.Path(os.environ['CHIP_SMOKE_OUT'])
        out.mkdir(parents=True, exist_ok=True)
        (out / 'chip_smoke.json').write_text(json.dumps(
            {'nvidia_smi': smi.strip(), 'jax': jax.__version__,
             'results': results}, indent=1, default=str))
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': len(devs)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
