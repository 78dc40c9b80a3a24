import numpy as np
import pytest

from dumphfdl_tpu import constants as C
from dumphfdl_tpu.ops import bits as bitops
from dumphfdl_tpu.ops import crc
from dumphfdl_tpu.ops import fec
from dumphfdl_tpu.ops import interleave
from dumphfdl_tpu.ops import psk


# --- CRC ------------------------------------------------------------------

def test_crc16_known_vector():
    # X.25 check value for "123456789": crc(init 0xFFFF) ^ 0xFFFF == 0x906E
    assert crc.fcs_compute(b'123456789') == 0x906E


def test_fcs_roundtrip():
    rng = np.random.default_rng(0)
    for n in (1, 5, 64):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        buf = crc.fcs_append(data)
        assert crc.fcs_check(buf, n)
        # flipping any byte breaks it
        bad = bytearray(buf)
        bad[0] ^= 0x40
        assert not crc.fcs_check(bytes(bad), n)


# --- bit order ------------------------------------------------------------

def test_reverse_bytes():
    assert bitops.reverse_bytes(np.array([0b10000000]))[0] == 1
    assert bitops.reverse_bytes(np.array([0x0F]))[0] == 0xF0
    data = np.arange(256, dtype=np.uint8)
    assert np.array_equal(bitops.reverse_bytes(bitops.reverse_bytes(data)), data)


def test_bit_packing_roundtrip():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 33, dtype=np.uint8)
    b = bitops.bytes_to_bits_lsb_first(data)
    assert np.array_equal(bitops.bits_to_bytes_lsb_first(b), data)
    assert b[0] == data[0] & 1


# --- interleaver ----------------------------------------------------------

@pytest.mark.parametrize('mode', range(8))
def test_interleaver_is_permutation(mode):
    d = interleave.deinterleave_perm(mode)
    i = interleave.interleave_perm(mode)
    n = C.MODES[mode].num_encoded_bits
    assert d.shape == (n,) and i.shape == (n,)
    assert np.array_equal(np.sort(d), np.arange(n))
    # deinterleave(interleave(x)) == x
    x = np.arange(n)
    tx = x[i]        # transmitted chip stream
    rx = tx[d]       # deinterleaved
    assert np.array_equal(rx, x)


def test_interleaver_matches_reference_walk():
    """Replay the reference's serial push/pop walk and compare."""
    mode = 0
    p = C.MODES[mode]
    rows, cols, shift = C.DEINTERLEAVER_ROW_CNT, p.interleaver_column_cnt, \
        p.interleaver_push_column_shift
    n = rows * cols
    table = np.zeros((rows, cols), dtype=np.int64)
    r = c = 0
    for k in range(n):       # push walk (hfdl.c:387-399)
        table[r, c] = k
        r += 1
        if r == rows:
            r = 0
            c += 1
        c -= shift
        if c < 0:
            c += cols
    popped = np.zeros(n, dtype=np.int64)
    r = c = 0
    for j in range(n):       # pop walk (hfdl.c:401-409)
        popped[j] = table[r, c]
        r = (r + C.DEINTERLEAVER_POP_ROW_SHIFT) % rows
        if r == 0:
            c += 1
    assert np.array_equal(popped, interleave.deinterleave_perm(mode))


# --- FEC ------------------------------------------------------------------

def test_conv_encode_known():
    # one '1' bit into a zero register: reg=1 -> c0=parity(1&0x6d)=1, c1=1
    chips = fec.conv_encode([1, 0, 0])
    assert list(chips[:2]) == [1, 1]


@pytest.mark.parametrize('nbits', [64, 540])
def test_viterbi_roundtrip_np(nbits):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, nbits).astype(np.int8)
    bits[-6:] = 0                      # flush bits
    soft = fec.hard_to_soft(fec.conv_encode(bits))
    out = fec.viterbi_decode_np(soft, nbits)
    assert np.array_equal(out, bits)


@pytest.mark.parametrize('nbits,batch_size', [(540, 3), (1080, 8)])
def test_viterbi_jax_matches_np(nbits, batch_size):
    rng = np.random.default_rng(3)
    batch = []
    golden = []
    for _ in range(batch_size):
        bits = rng.integers(0, 2, nbits).astype(np.int8)
        bits[-6:] = 0
        soft = fec.hard_to_soft(fec.conv_encode(bits)).astype(np.int32)
        # add soft noise
        noise = rng.integers(-60, 61, soft.shape)
        soft = np.clip(soft + noise, 0, 255)
        batch.append(soft)
        golden.append(fec.viterbi_decode_np(soft, nbits))
    out = np.asarray(fec.viterbi_decode(np.stack(batch), nbits))
    assert np.array_equal(out, np.stack(golden))


def test_viterbi_corrects_errors():
    rng = np.random.default_rng(4)
    nbits = 540
    bits = rng.integers(0, 2, nbits).astype(np.int8)
    bits[-6:] = 0
    chips = fec.conv_encode(bits)
    soft = fec.hard_to_soft(chips).astype(np.int32)
    # flip 5% of chips hard
    idx = rng.choice(len(soft), size=len(soft) // 20, replace=False)
    soft[idx] = 255 - soft[idx]
    out = np.asarray(fec.viterbi_decode(soft[None, :], nbits))[0]
    assert np.array_equal(out, bits)


# --- PSK ------------------------------------------------------------------

@pytest.mark.parametrize('arity', [C.M_BPSK, C.M_PSK4, C.M_PSK8])
def test_psk_roundtrip(arity):
    m = 1 << arity
    syms = np.arange(m)
    pts = psk.modulate(syms, arity)
    assert np.allclose(np.abs(pts), 1.0, atol=1e-6)
    back = psk.demodulate(pts, arity)
    assert np.array_equal(back, syms)
    # soft decisions agree with hard decisions on clean points
    soft = psk.soft_demodulate(pts, arity)
    hard_from_soft = (soft.astype(np.int32) > 127).astype(np.int64)
    expect = psk.symbols_to_bits(syms[:, None], arity).reshape(m, arity)
    assert np.array_equal(hard_from_soft, expect)


@pytest.mark.parametrize('arity', [C.M_BPSK, C.M_PSK4, C.M_PSK8])
def test_phase_error_zero_on_clean(arity):
    pts = psk.modulate(np.arange(1 << arity), arity)
    err = psk.phase_error(pts, arity)
    assert np.allclose(err, 0.0, atol=1e-5)
    rot = pts * np.exp(1j * 0.05)
    err = psk.phase_error(rot, arity)
    assert np.allclose(err, 0.05, atol=1e-5)


def test_bits_symbols_roundtrip():
    rng = np.random.default_rng(5)
    for arity in (1, 2, 3):
        bits = rng.integers(0, 2, 30 * arity).astype(np.int8)
        syms = psk.bits_to_symbols(bits, arity)
        assert np.array_equal(psk.symbols_to_bits(syms, arity), bits)


def test_device_put_cs16_roundtrip():
    import numpy as np
    from dumphfdl_tpu.utils.xfer import device_put_cs16
    rng = np.random.default_rng(5)
    x = (rng.uniform(-0.9, 0.9, 1000)
         + 1j * rng.uniform(-0.9, 0.9, 1000)).astype(np.complex64)
    x = x.reshape(4, 250)
    y = np.asarray(device_put_cs16(x))
    assert y.shape == x.shape
    assert np.max(np.abs(y - x)) < 1.0 / 32000  # CS16 quantization step
    # clipping beyond full scale
    z = np.asarray(device_put_cs16(np.array([[2.0 + 2.0j]], np.complex64)))
    assert abs(z[0, 0] - (1.0 + 1.0j)) < 1e-3


def test_device_prefetch_order_and_error():
    import numpy as np
    import pytest
    from dumphfdl_tpu.utils.prefetch import device_prefetch
    blocks = [np.full((2, 8), i / 10.0, np.complex64) for i in range(5)]
    out = [np.asarray(b)[0, 0].real for b in device_prefetch(blocks)]
    assert np.allclose(out, [0.0, 0.1, 0.2, 0.3, 0.4], atol=1e-4)

    def bad():
        yield blocks[0]
        raise RuntimeError('source died')

    it = device_prefetch(bad())
    next(it)
    with pytest.raises(RuntimeError, match='source died'):
        list(it)
