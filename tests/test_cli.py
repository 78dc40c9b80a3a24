"""Golden I/Q file decode through the full CLI stack."""

import json
import pathlib

import numpy as np
import pytest

from dumphfdl_tpu import cli
from dumphfdl_tpu.dsp import modulator
from dumphfdl_tpu.io import formats

SYSTABLE = str(pathlib.Path(__file__).resolve().parents[1]
               / 'etc' / 'systable.conf')


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
    """A CF32 wideband capture with one frame on each of two channels."""
    tmp = tmp_path_factory.mktemp('iq')
    fs = 48_000
    center = 8_930_000
    chans = [8_912_000, 8_942_000]
    rng = np.random.default_rng(5)
    pdus = [modulator.make_test_mpdu(1, rng, icao=0x4007F5),
            modulator.make_test_mpdu(2, rng, icao=0xA1B2C3)]
    wb = modulator.synthesize_wideband(
        [(pdus[0], 1, chans[0]), (pdus[1], 2, chans[1])],
        fs=fs, centerfreq=center, snr_db=30.0)
    path = tmp / 'capture.cf32'
    path.write_bytes(formats.serialize(wb, 'CF32'))
    return {'path': str(path), 'fs': fs, 'chans_khz': [c / 1000 for c in chans],
            'tmp': tmp}


def test_cli_text_output(capture):
    out = capture['tmp'] / 'out.txt'
    rc = cli.main([
        '--iq-file', capture['path'],
        '--sample-format', 'CF32',
        '--sample-rate', str(capture['fs']),
        '--centerfreq', '8930',
        '--system-table', SYSTABLE,
        '--utc',
        '--output', f'decoded:text:file:path={out}',
    ] + [str(k) for k in capture['chans_khz']])
    assert rc == 0
    text = out.read_text()
    assert 'Downlink LPDU' in text
    assert 'ICAO: 4007F5' in text
    assert 'ICAO: A1B2C3' in text
    assert 'Auckland' in text               # systable name for GS 5
    assert '[8912.0 kHz]' in text
    assert '[8942.0 kHz]' in text


def test_cli_json_output(capture):
    out = capture['tmp'] / 'out.json'
    rc = cli.main([
        '--iq-file', capture['path'],
        '--sample-format', 'CF32',
        '--sample-rate', str(capture['fs']),
        '--centerfreq', '8930',
        '--station-id', 'TEST-STATION',
        '--output', f'decoded:json:file:path={out}',
    ] + [str(k) for k in capture['chans_khz']])
    assert rc == 0
    lines = [json.loads(l) for l in out.read_text().splitlines() if l]
    assert len(lines) >= 2
    freqs = {l['hfdl']['freq'] for l in lines}
    assert freqs == {8_912_000, 8_942_000}
    assert all(l['hfdl']['station'] == 'TEST-STATION' for l in lines)
    icaos = {l['hfdl']['lpdu']['ac_info']['icao'] for l in lines}
    assert icaos == {'4007F5', 'A1B2C3'}
