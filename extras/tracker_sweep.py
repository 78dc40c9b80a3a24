#!/usr/bin/env python
"""Tracker symbol loop on the card: Triton kernel tiles vs lax.scan unrolls.

Times one block of the tracker (default: 1024 channels x 3584 symbols,
one super-block at 3.456 Msps) on frame-bearing input, for each kernel
channel tile and each scan unroll, and checks every kernel tile against
the scan on the frame channels.  Times are the median wall time of a
synchronized call (block_until_ready); compile times are printed
separately.

Usage: python extras/tracker_sweep.py [--channels 1024] [--steps 3584]
           [--tiles 16,32,64] [--unrolls 1,4,8] [--reps 5]
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--channels', type=int, default=1024)
    ap.add_argument('--steps', type=int, default=3584)
    ap.add_argument('--tiles', default='16,32,64')
    ap.add_argument('--unrolls', default='1,4,8')
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()

    import jax
    import numpy as np

    import chip_smoke as cs
    from dumphfdl_tpu.dsp.tracker import tracker_block, tracker_init
    from dumphfdl_tpu.dsp.tracker_pallas import tracker_block_kernel
    from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(json.dumps({'ok': False, 'error': f'no GPU ({dev.platform})'}))
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    nch, steps = args.channels, args.steps
    x, pdus = cs._tracker_inputs(nch, steps, 1, True)
    import jax.numpy as jnp
    from dumphfdl_tpu.dsp.channel import agc_block, agc_init, matched_filter
    from dumphfdl_tpu.dsp.tracker import HALO
    _, y, lv = agc_block(agc_init(nch), jnp.asarray(x))
    mfe = jnp.concatenate([jnp.zeros((nch, HALO), jnp.complex64),
                           matched_filter(y)], axis=1)
    lve = jnp.concatenate([jnp.ones((nch, HALO), jnp.float32), lv], axis=1)
    st = tracker_init(nch)
    chans = np.asarray(sorted(pdus))
    out = {'nvidia_smi': smi, 'channels': nch, 'steps': steps,
           'scan_s': {}, 'kernel_s': {}}
    ref = None
    for u in [int(v) for v in args.unrolls.split(',')]:
        fn = lambda: tracker_block(st, mfe, lve, steps, unroll=u)
        t = cs._device_time(fn, args.reps)
        out['scan_s'][u] = t
        print(f'scan unroll {u}: {t:.6f} s', flush=True)
        if ref is None:
            ref = fn()
    import time
    for tile in [int(v) for v in args.tiles.split(',')]:
        fn = lambda: tracker_block_kernel(st, mfe, lve, steps, tile=tile)
        t0 = time.perf_counter()
        tracker_block_kernel.lower(st, mfe, lve, steps, tile=tile).compile()
        out.setdefault('kernel_compile_s', {})[tile] = \
            time.perf_counter() - t0
        print(f'kernel tile {tile}: compiled in '
              f'{time.perf_counter() - t0:.3f} s', flush=True)
        s2, o2, ev2, _ = fn()
        same = (np.array_equal(np.asarray(ref[2])[chans],
                               np.asarray(ev2)[chans])
                and np.array_equal(np.asarray(ref[0].fr_state)[chans],
                                   np.asarray(s2.fr_state)[chans]))
        t = cs._device_time(fn, args.reps)
        out['kernel_s'][tile] = t
        print(f'kernel tile {tile}: {t:.6f} s, frame channels agree: {same}',
              flush=True)
        if not same:
            out['ok'] = False
    out.setdefault('ok', True)
    print(json.dumps(out), flush=True)
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
