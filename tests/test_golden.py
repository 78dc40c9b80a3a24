"""Golden capture regression: committed CS16 capture -> pinned decode.

The reference's de-facto regression mechanism is decoding a recorded
I/Q file and inspecting the message log (SURVEY.md §4).  This test keeps
a deterministic synthesized capture in-repo (generated once by
tests/make_golden.py) and pins the exact decoded PDU bytes, guarding the
whole DSP chain against silent behavioral drift.
"""

import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from dumphfdl_tpu.dsp.receiver import WidebandReceiver
from dumphfdl_tpu.io import formats

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def manifest():
    path = GOLDEN / 'manifest.json'
    if not path.exists():
        subprocess.run([sys.executable, str(GOLDEN.parent / 'make_golden.py')],
                       check=True, cwd='/root/repo')
    return json.loads(path.read_text())


def test_golden_capture_decodes(manifest):
    raw = (GOLDEN / manifest['capture']).read_bytes()
    assert hashlib.sha256(raw).hexdigest() == manifest['sha256']
    wb = formats.convert(raw, manifest['format'])
    rx = WidebandReceiver(manifest['sample_rate'], manifest['centerfreq'],
                          manifest['frequencies'])
    events = []
    step = manifest['sample_rate'] // 4
    for off in range(0, len(wb), step):
        events.extend(rx.process(wb[off:off + step]))
    events.extend(rx.flush())
    got = {(e.channel, e.mode): e.pdu.hex() for e in events if e.pdu}
    for exp in manifest['frames']:
        key = (exp['channel'], exp['mode'])
        assert key in got, f'frame missing: {exp}'
        assert got[key] == exp['pdu_hex'], f'PDU drift on {key}'


@pytest.mark.slow
def test_fused_event_decode_matches_host_path():
    """fused_event_decode decodes frames on device inside channel_step
    (the GPU single-readout collection path); forced on here (CPU) it
    must produce byte-identical PDUs to the host gather+decode path."""
    import numpy as np
    from dumphfdl_tpu import constants as C
    from dumphfdl_tpu.dsp import modulator
    from dumphfdl_tpu.dsp.channel import ChannelBank

    rng = np.random.default_rng(9)
    pdu = modulator.make_test_mpdu(1, rng, icao=0x3C0077)
    syms = modulator.frame_symbols(pdu, 1)
    iq = modulator.synthesize_iq(
        syms, imp=modulator.Impairments(snr_db=30.0, cfo_hz=-8.0,
                                        timing_offset=0.3, seed=4))
    noise = (rng.standard_normal(len(iq))
             + 1j * rng.standard_normal(len(iq))).astype(np.complex64) * 0.01
    x = np.stack([iq, noise]).astype(np.complex64)
    blk = 5400

    def run(**kw):
        bank = ChannelBank(2, auto_shard=False, **kw)
        evs = []
        for off in range(0, x.shape[1], blk):
            b = x[:, off:off + blk]
            if b.shape[1] < blk:
                b = np.pad(b, ((0, 0), (0, blk - b.shape[1])))
            evs += bank.process(b)
        evs += bank.process(np.zeros((2, blk), np.complex64))
        return evs

    ev_host = [e for e in run() if e.pdu]
    ev_fused = [e for e in run(fused_event_decode=4) if e.pdu]
    assert len(ev_host) == len(ev_fused) == 1
    assert ev_host[0].pdu == pdu
    assert ev_fused[0].pdu == pdu
    assert ev_fused[0] == ev_host[0]
