"""Protocol stack tests: MPDU/SPDU/LPDU/HFNPDU/ACARS + formatters."""

import pathlib
import time

import numpy as np
import pytest

from dumphfdl_tpu.io import formatters
from dumphfdl_tpu.ops import bits as bitops
from dumphfdl_tpu.ops import crc
from dumphfdl_tpu.protocol import acars as acars_mod
from dumphfdl_tpu.protocol import position as position_mod
from dumphfdl_tpu.protocol.enrichment import AcCache, SysTable, parse_icao_hex
from dumphfdl_tpu.protocol.pdu import PduMetadata, parse_pdu
from dumphfdl_tpu.protocol.runtime import ProtocolContext

SYSTABLE = str(pathlib.Path(__file__).resolve().parents[1]
               / 'etc' / 'systable.conf')


def icao_bytes(icao: int) -> bytes:
    return bytes(bitops.reverse_bytes(
        np.frombuffer(icao.to_bytes(3, 'big'), np.uint8)))


def make_lpdu(body: bytes) -> bytes:
    return crc.fcs_append(body)


def make_downlink_mpdu(lpdus: list[bytes], src_ac=0x42, dst_gs=0x05) -> bytes:
    hdr = bytes([0x3 | (len(lpdus) << 2), dst_gs, src_ac, 0, 0, 0]) \
        + bytes(len(p) - 1 for p in lpdus)
    return crc.fcs_append(hdr) + b''.join(lpdus)


def make_uplink_mpdu(lpdus: list[bytes], src_gs=0x03, dst_ac=0x11) -> bytes:
    hdr = bytes([0x1, src_gs, dst_ac, len(lpdus) << 4]) \
        + bytes(len(p) - 1 for p in lpdus)
    return crc.fcs_append(hdr) + b''.join(lpdus)


def make_perf_hfnpdu(lat_deg, lon_deg, hour, minute, sec, flight=b'BAW123'):
    perf = bytearray(47)
    perf[0] = 0xFF
    perf[1] = 0xD1
    perf[2:8] = flight
    lat = int(lat_deg / 180 * 0x7FFFF) & 0xFFFFF
    lon = int(lon_deg / 180 * 0x7FFFF) & 0xFFFFF
    perf[8] = lat & 0xFF
    perf[9] = (lat >> 8) & 0xFF
    perf[10] = ((lat >> 16) & 0xF) | ((lon & 0xF) << 4)
    perf[11] = (lon >> 4) & 0xFF
    perf[12] = (lon >> 12) & 0xFF
    s2 = (hour * 3600 + minute * 60 + sec) // 2
    perf[13] = s2 & 0xFF
    perf[14] = s2 >> 8
    return bytes(perf)


@pytest.fixture
def ctx():
    c = ProtocolContext()
    c.systable.load(SYSTABLE)
    return c


@pytest.fixture
def meta():
    return PduMetadata(freq=8912000, rx_timestamp=time.time(),
                       bit_rate=600, slot='S', rssi=-20.0,
                       noise_floor=-40.0, freq_err_hz=1.2)


def test_icao_parse():
    # util.c:236-242: bit-reversed octets, big-endian
    assert parse_icao_hex(bytes([0x80, 0x00, 0x01])) == 0x010080


def test_downlink_logon_and_perf(ctx, meta):
    lp1 = make_lpdu(bytes([0x8F]) + icao_bytes(0x4007F5))
    now = time.gmtime()
    lp2 = make_lpdu(bytes([0x0D]) + make_perf_hfnpdu(
        51.5, -0.12, now.tm_hour, now.tm_min, max(0, now.tm_sec - 5)))
    trees = parse_pdu(make_downlink_mpdu([lp1, lp2]), meta, ctx)
    assert len(trees) == 2
    txt = trees[0].format_text()
    assert 'Logon request (normal)' in txt
    assert 'ICAO: 4007F5' in txt
    assert 'Auckland' in txt            # systable enrichment
    txt2 = trees[1].format_text()
    assert 'Performance data' in txt2
    assert 'BAW123' in txt2
    js = trees[1].to_json()
    assert abs(js['hfnpdu']['pos']['lat'] - 51.5) < 0.001


def test_uplink_mpdu_and_ac_cache(ctx, meta):
    # logon confirm creates an AC cache mapping (lpdu.c:168-176)
    lp = make_lpdu(bytes([0x9F]) + icao_bytes(0xABCDEF) + bytes([0x21, 0, 0, 0]))
    trees = parse_pdu(make_uplink_mpdu([lp], dst_ac=0x21), meta, ctx)
    assert len(trees) == 1
    assert ctx.ac_cache.lookup(meta.freq, 0x21) == 0xABCDEF
    # logoff deletes it
    lp2 = make_lpdu(bytes([0x3F]) + icao_bytes(0xABCDEF) + bytes([0x06]))
    parse_pdu(make_uplink_mpdu([lp2]), meta, ctx)
    assert ctx.ac_cache.lookup(meta.freq, 0x21) is None


def test_bad_fcs_rejected(ctx, meta):
    lp = make_lpdu(bytes([0x8F]) + icao_bytes(0x4007F5))
    buf = bytearray(make_downlink_mpdu([lp]))
    buf[1] ^= 0x40                      # corrupt header
    assert parse_pdu(bytes(buf), meta, ctx) == []


def test_spdu_parse(ctx, meta):
    buf = bytearray(66)
    buf[0] = 0x2 | (1 << 2)             # not MPDU (bit0=0), rls, version 1
    buf[1] = 0x80 | 0x05                # utc sync + GS 5
    buf[2] = 0x34                       # frame index low
    buf[3] = 0x12                       # index high nibble + offset 1
    buf[52] = 0x3
    buf[53] = 52                        # systable version
    buf[54] = (0x0) | (0x1 << 4)        # freq bitmap low bits
    fcs = crc.fcs_compute(bytes(buf[:64]))
    buf[64] = fcs & 0xFF
    buf[65] = fcs >> 8
    trees = parse_pdu(bytes(buf), meta, ctx)
    assert len(trees) == 1
    d = trees[0].data
    assert d['src_id'] == 5
    assert d['systable_version'] == 52
    assert d['frame_index'] == 0x234
    txt = trees[0].format_text()
    assert 'Uplink SPDU' in txt
    assert 'Auckland' in txt


def test_acars_basic(ctx, meta):
    # ACARS downlink: SOH mode reg ack label blkid STX msgnum flight text ETX
    acars = (b'\x01' + b'2' + b'.HFDLTU' + b'\x15' + b'H1' + b'1'
             + b'\x02' + b'M01A' + b'BA0123' + b'HELLO WORLD' + b'\x03')
    lp = make_lpdu(bytes([0x0D, 0xFF, 0xFF]) + acars)
    trees = parse_pdu(make_downlink_mpdu([lp]), meta, ctx)
    assert len(trees) == 1
    node = trees[0].find('acars')
    assert node is not None
    assert node.data['reg'] == 'HFDLTU'
    assert node.data['flight_id'] == 'BA0123'
    assert node.data['text'] == 'HELLO WORLD'
    assert 'HELLO WORLD' in trees[0].format_text()


def test_acars_multiblock_reassembly(ctx):
    r = acars_mod.ReasmCtx()
    st, _, _ = r.add('air2gnd', 'REG', 'H1', 'M01', 'A', 'part1 ', True,
                     raw=b'part1 ')
    assert st == acars_mod.REASM_IN_PROGRESS
    st, text, raw = r.add('air2gnd', 'REG', 'H1', 'M01', 'B', 'part2', False,
                          raw=b'part2')
    assert st == acars_mod.REASM_COMPLETE
    assert text == 'part1 part2'
    assert raw == b'part1 part2'


def test_basestation_formatter(ctx, meta):
    now = time.gmtime()
    lp1 = make_lpdu(bytes([0x8F]) + icao_bytes(0x4007F5))
    lp2 = make_lpdu(bytes([0x0D]) + make_perf_hfnpdu(
        48.0, 11.0, now.tm_hour, now.tm_min, max(0, now.tm_sec - 2)))
    # one MPDU with both: position extraction picks up ICAO from the
    # logon LPDU in the same tree? (reference: per-LPDU trees; ICAO comes
    # from the logon-request LPDU type in its own tree)
    trees = parse_pdu(make_downlink_mpdu([lp1, lp2]), meta, ctx)
    ctx.options.freq_as_squawk = True
    bs = formatters.create('basestation', ctx)
    # tree 2 (perf data) has no ICAO and no cache entry -> None
    assert bs.format(meta, trees[1]) is None
    # after a logon confirm caches the AC id, position resolves
    lpc = make_lpdu(bytes([0x9F]) + icao_bytes(0x4007F5) + bytes([0x42, 0, 0, 0]))
    parse_pdu(make_uplink_mpdu([lpc], dst_ac=0x42), meta, ctx)
    trees = parse_pdu(make_downlink_mpdu([lp2], src_ac=0x42), meta, ctx)
    out = bs.format(meta, trees[0])
    assert out is not None
    assert out.startswith('MSG,3,1,1,4007F5,1,')
    assert ',8912,' in out


def test_systable_ota_roundtrip(tmp_path):
    """Encode a binary GS table, fragment it, reassemble via store_pdu."""
    st = SysTable()
    st.version = 10
    # build binary records for 2 stations
    def coord(deg):
        return int(deg / 180 * 0x7FFFF) & 0xFFFFF

    def record(gs_id, lat, lon, freqs_khz):
        lat_r, lon_r = coord(lat), coord(lon)
        b = bytes([
            0x80 | gs_id,
            lat_r & 0xFF, (lat_r >> 8) & 0xFF,
            ((lat_r >> 16) & 0xF) | ((lon_r & 0xF) << 4),
            (lon_r >> 4) & 0xFF, (lon_r >> 12) & 0xFF,
            (len(freqs_khz) << 3) | 2,
        ])
        for f in freqs_khz:
            hz = int(f * 1000)
            digits = [(hz // 10 ** p) % 10 for p in range(2, 8)]
            b += bytes([digits[0] | digits[1] << 4,
                        digits[2] | digits[3] << 4,
                        digits[4] | digits[5] << 4,
                        0x1])
        return b

    blob = record(1, 38.4, -121.8, [21934.0, 8927.0]) \
        + record(2, 21.2, -157.2, [13276.0])
    st.store_pdu(11, 0, 2, blob[:10])
    assert st.process_pdu_set() is None      # incomplete
    st.store_pdu(11, 1, 2, blob[10:])
    summary = st.process_pdu_set()
    assert summary is not None
    assert st.version == 11
    assert st.station_frequency(1, 0) == 21934.0
    assert st.station_frequency(2, 0) == 13276.0
    assert abs(st.stations[1].lat - 38.4) < 0.01
    # save + reload roundtrip
    p = tmp_path / 'systable.conf'
    st.save_path = str(p)
    assert st.save()
    st2 = SysTable(str(p))
    assert st2.version == 11
    assert st2.station_frequency(1, 1) == 8927.0


def test_systable_version_wraparound():
    st = SysTable()
    st.version = 4090
    assert st._version_is_newer(5)       # wrapped
    assert not st._version_is_newer(3000)
    assert not st._version_is_newer(4090)


def test_ac_cache_ttl():
    cache = AcCache(ttl=0.01)
    cache.create(8912000, 0x21, 0xABCDEF)
    assert cache.lookup(8912000, 0x21) == 0xABCDEF
    time.sleep(0.02)
    assert cache.lookup(8912000, 0x21) is None
    assert cache.expire() == 0


# ---------------------------------------------------------------------------
# MIAM (ARINC 841) recognition
# ---------------------------------------------------------------------------

def test_miam_single_transfer_with_deflate():
    import zlib
    from dumphfdl_tpu.protocol import miam
    payload = zlib.compress(b'HELLO MIAM WORLD' * 4)
    body = b'T' + b'1' + b'0' + b'xx' + payload
    node = miam.parse('MA', body.decode('latin-1'), body)
    assert node is not None
    d = node.data
    assert d['frame_type'] == 'Single Transfer'
    core = d['core']
    assert core['version'] == 1
    assert core['pdu_type'] == 'Data'
    assert core['compression'].startswith('deflate')
    txt_lines = []
    node.text_formatter(node, txt_lines, 0)
    assert any('Single Transfer' in ln for ln in txt_lines)
    assert any('deflate' in ln for ln in txt_lines)


def test_miam_frame_id_table():
    from dumphfdl_tpu.protocol import miam
    for fid, name in [('F', 'File Transfer Request'), ('S', 'File Segment'),
                      ('K', 'File Transfer Accept'), ('A', 'File Transfer Abort'),
                      ('X', 'MIAM XON IND'), ('Y', 'MIAM XOFF IND')]:
        node = miam.parse('MA', fid + 'data', (fid + 'data').encode())
        assert node.data['frame_type'] == name
    assert miam.parse('MA', 'Qjunk', b'Qjunk') is None   # unknown frame id
    assert miam.parse('H1', 'Tdata', b'Tdata') is None   # wrong label


def test_miam_in_acars_tree():
    """Label 'MA' ACARS message grows a MIAM child node."""
    from dumphfdl_tpu.protocol import acars as acars_mod
    from dumphfdl_tpu.protocol.runtime import ProtocolContext
    ctx = ProtocolContext()
    body = b'T10' + b'\x00\x01binary'
    buf = (b'\x01' + b'2' + b'.HFDLTU' + b'\x15' + b'MA' + b'2'
           + b'\x02' + b'M01A' + b'AF0001' + body + b'\x03')
    node = acars_mod.parse(buf, 'downlink', None, ctx)
    assert node is not None and not node.data['err']
    assert node.data['label'] == 'MA'
    assert node.next is not None and node.next.json_key == "miam"
    assert node.next.data['frame_type'] == 'Single Transfer'


def test_miam_core_body_text_payload():
    """Deflated printable payload is decompressed and shown as text."""
    import zlib
    from dumphfdl_tpu.protocol import miam
    payload = zlib.compress(b'WX REPORT KSFO 12009KT 10SM FEW200')
    body = b'T' + b'1' + b'0' + payload
    node = miam.parse('MA', body.decode('latin-1'), body)
    core = node.data['core']
    assert core['app'] == 'text'
    assert 'WX REPORT KSFO' in core['app_text']
    lines = []
    node.text_formatter(node, lines, 0)
    assert any('WX REPORT KSFO' in ln for ln in lines)


def test_miam_core_embedded_acars_recursion():
    """A deflated embedded ACARS message grows a recursive acars child."""
    import zlib
    from dumphfdl_tpu.protocol import miam
    from dumphfdl_tpu.protocol.runtime import ProtocolContext
    ctx = ProtocolContext()
    inner = (b'\x01' + b'2' + b'.HFDLTU' + b'\x15' + b'H1' + b'4'
             + b'\x02' + b'M02A' + b'AF0002' + b'INNER PAYLOAD' + b'\x03')
    body = b'T' + b'1' + b'0' + zlib.compress(inner)
    node = miam.parse('MA', body.decode('latin-1'), body,
                      msg_dir='air2gnd', ctx=ctx)
    core = node.data['core']
    assert core['app'] == 'ACARS message'
    assert node.next is not None and node.next.json_key == 'acars'
    assert node.next.data['label'] == 'H1'
    assert 'INNER PAYLOAD' in node.next.data['text']


def test_miam_core_base85_armored():
    """base85-armored deflate body is unarmored, inflated, classified."""
    import base64
    import zlib
    from dumphfdl_tpu.protocol import miam
    blob = zlib.compress(b'ARMORED APPLICATION DATA 1234')
    text = 'T10' + base64.b85encode(blob).decode()
    node = miam.parse('MA', text, text.encode('latin-1'))
    core = node.data['core']
    assert 'armored' in core['compression']
    assert core['app'] == 'text'
    assert 'ARMORED APPLICATION DATA' in core['app_text']


def test_prettify_xml_in_acars_text():
    """--prettify-xml: XML ACARS payloads render indented (main.c:305)."""
    from dumphfdl_tpu.protocol import acars as acars_mod
    from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
    xml = '<ohma><msg id="1"><val>7</val></msg></ohma>'
    buf = (b'\x01' + b'2' + b'.HFDLTU' + b'\x15' + b'H1' + b'3'
           + b'\x02' + b'M03A' + b'AF0003' + xml.encode() + b'\x03')
    for pretty in (False, True):
        ctx = ProtocolContext(options=ProtocolOptions(prettify_xml=pretty))
        node = acars_mod.parse(buf, 'downlink', None, ctx)
        lines = []
        node.text_formatter(node, lines, 0)
        nested = any(ln.strip() == '<val>7</val>' for ln in lines)
        assert nested == pretty, lines
    # malformed XML passes through unchanged
    assert acars_mod.prettify_xml('<unclosed') == '<unclosed'
    assert acars_mod.prettify_xml('plain text') == 'plain text'


def test_ohma_in_acars_tree():
    """An 'OHMA'+base64(zlib(JSON)) text body grows an OHMA child whose
    JSON decodes; --prettify-json indents the text rendering."""
    import base64
    import json
    import zlib
    from dumphfdl_tpu.protocol import acars as acars_mod
    from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
    doc = {'version': 1, 'type': 'engine', 'samples': [1, 2, 3]}
    body = ('OHMA' + base64.b64encode(
        zlib.compress(json.dumps(doc).encode())).decode()).encode()
    buf = (b'\x01' + b'2' + b'.N737MX' + b'\x15' + b'H1' + b'2'
           + b'\x02' + b'D64A' + b'BA0038' + body + b'\x03')
    ctx = ProtocolContext()
    node = acars_mod.parse(buf, 'downlink', None, ctx)
    assert node is not None and not node.data['err']
    assert node.next is not None and node.next.json_key == 'ohma'
    assert node.next.data['ok'] and node.next.data['json'] == doc
    lines = []
    node.next.text_formatter(node.next, lines, 0)
    assert any('OHMA message:' in ln for ln in lines)
    assert any('"engine"' in ln for ln in lines)
    # prettified rendering spans multiple lines
    ctx2 = ProtocolContext(options=ProtocolOptions(prettify_json=True))
    node2 = acars_mod.parse(buf, 'downlink', None, ctx2)
    lines2 = []
    node2.next.text_formatter(node2.next, lines2, 0)
    assert len(lines2) > len(lines)


def test_ohma_bad_payload_degrades():
    from dumphfdl_tpu.protocol import ohma
    node = ohma.parse('OHMAnot-base64-zlib!!')
    assert node is not None and not node.data['ok']
    lines = []
    node.text_formatter(node, lines, 0)
    assert any('Unparseable OHMA' in ln for ln in lines)
    assert ohma.parse('plain text') is None


def test_miam_file_transfer_reassembly_roundtrip():
    """F -> S x n -> assembled file runs the CORE pipeline (VERDICT r4 #6)."""
    import zlib
    from dumphfdl_tpu.protocol import miam
    from dumphfdl_tpu.protocol.runtime import ProtocolContext

    ctx = ProtocolContext()
    sent = []
    ctx.statsd.increment_per_msgdir = \
        lambda d, m: sent.append((d, m))   # record counters

    import numpy as _np
    secret = _np.random.default_rng(9).integers(
        0, 256, 2000, dtype=_np.uint8).tobytes()      # incompressible
    filebody = b'10' + zlib.compress(secret)          # CORE: v1, Data
    segs = [filebody[i:i + 256] for i in range(0, len(filebody), 256)]
    assert len(segs) >= 4

    def frame(txt: bytes):
        return miam.parse('MA', txt.decode('latin-1'), txt,
                          msg_dir='air2gnd', ctx=ctx, reg='SP-MIA')

    n = frame(b'F001%06d' % len(filebody))            # request
    assert n.data['file_id'] == 1
    assert n.data['file_size'] == len(filebody)
    assert n.data['reasm_status'] == miam.REASM_IN_PROGRESS

    # out-of-order segment arrival; duplicate before completion
    order = list(range(len(segs)))
    order = order[1::2] + order[0::2]      # final segment arrives last
    for k in order[:-1]:
        mid = frame(b'S001%03d' % (k + 1) + segs[k])
        assert mid.data['reasm_status'] == miam.REASM_IN_PROGRESS
    dup = frame(b'S001%03d' % (order[0] + 1) + segs[order[0]])
    assert dup.data['reasm_status'] == miam.REASM_DUPLICATE
    last = frame(b'S001%03d' % (order[-1] + 1) + segs[order[-1]])
    assert last.data['reasm_status'] == miam.REASM_COMPLETE
    assert last.data['assembled_len'] == len(filebody)
    core = last.data['core']
    assert core['version'] == 1
    assert core['compression'].startswith('deflate')
    assert core['decompressed_len'] == len(secret)
    # per-direction counters fired, mirroring acars.c:47-52 semantics
    assert ('air2gnd', 'miam.reasm.complete') in sent
    # in_progress is never counted (final states only)
    assert not any(m.endswith('in_progress') for _, m in sent)


def test_miam_file_transfer_abort_and_skip():
    from dumphfdl_tpu.protocol import miam
    from dumphfdl_tpu.protocol.runtime import ProtocolContext

    ctx = ProtocolContext()

    def frame(txt: bytes, reg='SP-MIA'):
        return miam.parse('MA', txt.decode('latin-1'), txt,
                          msg_dir='air2gnd', ctx=ctx, reg=reg)

    # segment without a request -> skipped
    n = frame(b'S005001DATA')
    assert n.data['reasm_status'] == miam.REASM_SKIPPED
    # request then abort drops the transfer
    frame(b'F005000100')
    a = frame(b'A0052')
    assert a.data['transfer_dropped'] is True
    assert a.data['reason'] == 'file transfer cancelled'
    n2 = frame(b'S005001DATA')
    assert n2.data['reasm_status'] == miam.REASM_SKIPPED
    # transfers key by registration: another aircraft's segments are
    # isolated
    frame(b'F007000004')
    other = frame(b'S007001ABCD', reg='N12345')
    assert other.data['reasm_status'] == miam.REASM_SKIPPED
    mine = frame(b'S007001ABCD')
    assert mine.data['reasm_status'] == miam.REASM_COMPLETE


def test_miam_xon_xoff_fields():
    from dumphfdl_tpu.protocol import miam
    assert miam.parse('MA', 'XALL', b'XALL').data['file_id'] == 'ALL'
    assert miam.parse('MA', 'Y042', b'Y042').data['file_id'] == 42
