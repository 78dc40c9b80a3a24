#!/usr/bin/env python
"""chip_smoke.py phase b (1024 channels at 3.456 Msps, superstep) with other
implementation choices: each tracker, and the on-device event decode on
(64 frames per block) or off (the per-mode gather path).

Every variant settles the same exact frame ledger as the smoke test and
prints its real-time factor.  Compare variants only within one run.

Usage: python extras/e2e_variants.py [--variants scan:64,kernel:0]
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--variants', default='scan:64,kernel:0')
    ap.add_argument('--channels', type=int, default=1024)
    ap.add_argument('--fs', type=int, default=3_456_000)
    args = ap.parse_args()
    import jax

    import chip_smoke as cs
    from dumphfdl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(json.dumps({'ok': False, 'error': f'no GPU ({dev.platform})'}))
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = []
    for v in args.variants.split(','):
        tracker, fused = v.split(':')
        res = cs.phase_wideband(args.channels, args.fs, 16200, superstep=True,
                                tracker=tracker,
                                fused_event_decode=int(fused))
        out.append({k: res[k] for k in ('tracker', 'fused_event_decode',
                                        'rt_factor', 'timed_wall_s',
                                        'stream_s', 'warm_s', 'frames_ok',
                                        'frames_lost')})
    print(json.dumps({'ok': True, 'device': dev.device_kind,
                      'variants': out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
