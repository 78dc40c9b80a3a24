"""Enrichment: basestation SQLite DB, systable file parsing, debug utils."""

import pathlib
import sqlite3

import pytest

from dumphfdl_tpu.protocol.enrichment import AcData, SysTable
from dumphfdl_tpu.protocol.runtime import ProtocolContext
from dumphfdl_tpu.utils import debug

SYSTABLE = str(pathlib.Path(__file__).resolve().parents[1]
               / 'etc' / 'systable.conf')


@pytest.fixture
def bs_db(tmp_path):
    path = tmp_path / 'basestation.sqb'
    conn = sqlite3.connect(path)
    conn.execute('''CREATE TABLE Aircraft (
        ModeS TEXT PRIMARY KEY, Registration TEXT, ICAOTypeCode TEXT,
        OperatorFlagCode TEXT, Manufacturer TEXT, Type TEXT,
        RegisteredOwners TEXT)''')
    conn.execute('INSERT INTO Aircraft VALUES (?,?,?,?,?,?,?)',
                 ('4007F5', 'G-EUUU', 'A320', 'BAW', 'Airbus',
                  'A320-232', 'British Airways'))
    conn.commit()
    conn.close()
    return str(path)


def test_ac_data_lookup(bs_db):
    db = AcData(bs_db)
    e = db.lookup(0x4007F5)
    assert e.registration == 'G-EUUU'
    assert e.icaotypecode == 'A320'
    assert e.registeredowners == 'British Airways'
    # negative result cached without error
    assert db.lookup(0x123456) is None
    assert db.lookup(0x123456) is None
    db.close()


def test_ac_data_formatting(bs_db):
    ctx = ProtocolContext()
    ctx.ac_data = AcData(bs_db)
    txt = ctx.ac_info_text(0x4007F5)
    assert txt == 'AC info: G-EUUU, A320, BAW'
    ctx.options.ac_data_details = 'verbose'
    txt = ctx.ac_info_text(0x4007F5)
    assert 'Airbus' in txt and 'British Airways' in txt
    js = ctx.ac_info_json(0x4007F5)
    assert js['regnr'] == 'G-EUUU'
    ctx.ac_data.close()


def test_systable_reference_file():
    st = SysTable(SYSTABLE)
    assert st.version == 52
    assert st.station_name(1) == 'San Francisco, California'
    assert st.station_frequency(1, 0) == 21934.0
    assert st.station_frequency(99, 0) is None
    assert st.station_frequency(1, 99) is None


def test_debug_classes(capsys):
    debug.set_classes('dsp,frame')
    assert debug.enabled('dsp')
    assert debug.enabled('frame')
    assert not debug.enabled('proto')
    debug.debug_print('dsp', 'hello')
    debug.debug_print('proto', 'hidden')
    err = capsys.readouterr().err
    assert '[dsp] hello' in err
    assert 'hidden' not in err
    with pytest.raises(ValueError):
        debug.set_classes('bogus')
    debug.set_classes('none')


# ---------------------------------------------------------------------------
# libconfig parser (protocol/libconfig.py) + systable schema validation
# ---------------------------------------------------------------------------

def test_libconfig_grammar():
    from dumphfdl_tpu.protocol import libconfig
    cfg = libconfig.loads('''
        // line comment
        # hash comment
        version = 7; /* block
           comment */
        flag = true; neg = -2.5e1;
        hexv = 0x1F;
        s = "a\\"b" "-cat";
        grp = { inner = { x = 1; }; arr = [1, 2, 3]; };
        lst = ( 1, "two", ( 3.0 ), { y = 2; } );
    ''')
    assert cfg['version'] == 7 and cfg['flag'] is True
    assert cfg['neg'] == -25.0 and cfg['hexv'] == 31
    assert cfg['s'] == 'a"b-cat'
    assert cfg['grp']['inner']['x'] == 1 and cfg['grp']['arr'] == [1, 2, 3]
    assert cfg['lst'][2] == [3.0] and cfg['lst'][3]['y'] == 2
    # round-trip through dumps
    assert libconfig.loads(libconfig.dumps(cfg)) == cfg


def test_libconfig_rejects_malformed():
    import pytest
    from dumphfdl_tpu.protocol import libconfig
    for bad in ('x = ;', 'x = 1', 'x = (1,,2);', 'g = { x = 1;',
                'x = 1; x = 2;', '= 5;', 'x = "unterminated;'):
        with pytest.raises(libconfig.LibconfigError):
            libconfig.loads(bad)


def test_systable_roundtrip_extras(tmp_path):
    st = SysTable(SYSTABLE)
    assert st.available and len(st.stations) >= 10
    st.stations[1].utc_sync = True
    st.stations[1].master_frame_slots = [0, 3, 1]
    p = tmp_path / 'st.conf'
    assert st.save(str(p))
    st2 = SysTable(str(p))
    assert st2.available and st2.version == st.version
    assert st2.stations[1].utc_sync is True
    assert st2.stations[1].master_frame_slots == [0, 3, 1]
    assert st2.stations[2].frequencies == st.stations[2].frequencies
    assert st2.stations[1].name == st.stations[1].name


def test_systable_rejects_corrupt(tmp_path, capsys):
    p = tmp_path / 'bad.conf'
    p.write_text('version = 3; stations = ( { id = 1; lat = "oops"; lon = 1.0; } );')
    st = SysTable(str(p))
    assert not st.available
    assert 'bad lat/lon' in capsys.readouterr().err
    p2 = tmp_path / 'nested.conf'
    # nested groups + comments inside a station must parse, not corrupt
    p2.write_text('''version = 9;
        stations = ( { id = 4; /* brace } in comment */ name = "N";
                       lat = 1.0; lon = 2.0; meta = { note = "x"; };
                       frequencies = ( 100.0 ); } );''')
    st2 = SysTable(str(p2))
    assert st2.available and st2.stations[4].name == 'N'
    assert st2.stations[4].frequencies == [100.0]
