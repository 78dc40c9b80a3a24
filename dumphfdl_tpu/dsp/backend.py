"""Frame backend: scrambled data symbols -> PDU octets, batched on device.

Everything from descrambling through Viterbi chainback is a feed-forward,
statically-shaped array program per mode, so frames collected from many
channels are decoded as one batch:

  phase flips (scrambler + BPSK ambiguity) -> soft PSK demod ->
  deinterleave gather -> (rate-1/4 chip averaging) -> batched Viterbi ->
  LSB-first byte packing.

Reference behavior: /root/reference/src/hfdl.c:993-1056.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import sequences as seq
from ..ops import bits as bitops
from ..ops import fec
from ..ops import interleave
from ..ops import psk


def _decode_core(data_symbols: jax.Array, bitmask: jax.Array,
                 mode: int) -> jax.Array:
    """Traceable decode body (jit-wrapped below; also inlined into the
    fused on-device event decode in decode_events_inline)."""
    p = C.MODES[mode]
    scr = jnp.asarray(seq.bipolar(seq.scrambler_for_symbols(p.num_data_symbols)))
    flip = jnp.where(jnp.asarray(bitmask).reshape(-1).astype(bool),
                     -1.0, 1.0)[:, None]
    syms = data_symbols * scr[None, :] * flip
    soft = psk.soft_demodulate(syms, p.arity)            # (B, S, arity) uint8
    soft = soft.reshape(syms.shape[0], p.num_encoded_bits)
    perm = jnp.asarray(interleave.deinterleave_perm(mode))
    soft = jnp.take(soft, perm, axis=1)
    if p.code_rate == 4:
        pairs = soft.reshape(soft.shape[0], -1, 2).astype(jnp.int32)
        a, b = pairs[..., 0], pairs[..., 1]
        soft = ((a & b) + ((a ^ b) >> 1)).astype(jnp.uint8)  # floor avg (hfdl.c:1032)
    return fec.viterbi_decode(soft, p.framebits)


@functools.partial(jax.jit, static_argnames=('mode',))
def decode_frame_batch(data_symbols: jax.Array,
                       bitmask: jax.Array,
                       mode: int) -> jax.Array:
    """Decode a batch of frames of one mode.

    Args:
      data_symbols: (B, num_data_symbols) complex64 equalized data symbols.
      bitmask: (B,) int32/bool; 1 when the Costas loop locked pi out of
        phase (A-correlation was negative) -> extra phase flip
        (hfdl.c:788,1013).
      mode: 0..7 (static).

    Returns:
      (B, framebits) int8 decoded bits (pack with pdu_bytes_from_bits).
    """
    return _decode_core(data_symbols, bitmask, mode)


# ---- fused on-device event decode --------------------------------------
#
# Completed frames can be decoded on device straight from the symbol ring
# and event table, so the host reads back ONE buffer per block (event
# table + packed decoded bits) instead of driving a gather + per-mode
# decode chain with a readback per mode (the reference's analogue is the
# single PDU-decoder thread, pdu.c:91).

MAX_FRAMEBITS = max(m.framebits for m in C.MODES)
PACK_WORDS = (MAX_FRAMEBITS + 31) // 32

# largest FCS-protected header: uplink MPDU with 8 aircraft x 15 LPDUs
# (2 + 8*(2+15) bytes, mpdu.c:60-75); SPDU = 64; downlink <= 21
_HDR_MAX_BYTES = 144


def _device_fcs_ok(bits: jax.Array) -> jax.Array:
    """Header-FCS check for a batch of decoded frames, on device.

    bits: (E, F) int32 LSB-first-per-byte frame bits (the order the
    reflected CRC-16/CCITT consumes them, crc.c:4-47).  Computes each
    frame's header length from its first bytes exactly like the host
    parsers (SPDU: 64, spdu.c:40; downlink MPDU: 6+lpdu_cnt; uplink
    MPDU: per-aircraft size walk, mpdu.c:56-75), runs the reflected CRC
    over the header bit stream, and compares with the little-endian FCS
    that follows (pdu.c:66-79).  Frames failing this check are junk
    (noise false-locks or uncorrected errors): the host can skip deep
    parsing and count them, instead of burning parse time (VERDICT r3
    #2/#3).
    """
    e, f = bits.shape
    nbytes = min(f // 8, _HDR_MAX_BYTES + 2)
    byts = jnp.sum(
        bits[:, :nbytes * 8].reshape(e, nbytes, 8)
        << jnp.arange(8, dtype=jnp.int32)[None, None, :], axis=-1)
    b0 = byts[:, 0]
    is_mpdu = (b0 & 1) == 1
    downlink = (b0 & 2) == 2
    # uplink header walk (bounded: <= 8 aircraft)
    ac_cnt = ((b0 & 0x70) >> 4) + 1
    h = jnp.full((e,), 2, jnp.int32)
    for it in range(8):
        active = (it < ac_cnt) & is_mpdu & ~downlink
        nb = jnp.take_along_axis(
            byts, jnp.clip(h + 1, 0, nbytes - 1)[:, None], axis=1)[:, 0] >> 4
        h = jnp.where(active, h + 2 + nb, h)
    hdr_len = jnp.where(is_mpdu,
                        jnp.where(downlink, 6 + ((b0 >> 2) & 0xF), h),
                        64)
    hdr_len = jnp.clip(hdr_len, 1, nbytes - 2)
    fits = hdr_len + 2 <= nbytes
    # reflected CRC over the header bit stream, capturing at 8*hdr_len
    n_hdr_bits = 8 * (nbytes - 2)
    xs = bits[:, :n_hdr_bits].T.astype(jnp.int32)          # (T, E)

    def step(carry, xt):
        crc, cap, t = carry
        crc = crc ^ xt
        crc = (crc >> 1) ^ (crc & 1) * 0x8408
        cap = jnp.where(t + 1 == hdr_len * 8, crc, cap)
        return (crc, cap, t + 1), None

    init = (jnp.full((e,), 0xFFFF, jnp.int32),
            jnp.zeros((e,), jnp.int32), jnp.int32(0))
    (_, crc_at_hdr, _), _ = jax.lax.scan(step, init, xs, unroll=16)
    fcs = crc_at_hdr ^ 0xFFFF
    exp = jnp.take_along_axis(byts, hdr_len[:, None], axis=1)[:, 0] \
        | (jnp.take_along_axis(byts, (hdr_len + 1)[:, None],
                               axis=1)[:, 0] << 8)
    return fits & (fcs == exp)


# data-symbol schedule within a frame: data symbol d sits
# FIRST_DATA_OFFSET + 45*(d//30) + d%30 symbols after the frame start
# (30-symbol data halves interleaved with 15-symbol training probes,
# hfdl.c:54-62 FSM; offsets calibrated exactly in r4 for all 8 modes)
FIRST_DATA_OFFSET = C.PREKEY_LEN + C.PREAMBLE_LEN        # 979


@functools.cache
def _data_schedule() -> np.ndarray:
    d = np.arange(C.DATA_SYMBOLS_MAX)
    return (45 * (d // 30) + d % 30).astype(np.int32)


def gather_event_symbols(symring: jax.Array, start22: jax.Array,
                         base22: jax.Array, ch: jax.Array) -> jax.Array:
    """(E, DATA_SYMBOLS_MAX) data symbols for events from the contiguous
    per-channel symbol ring.

    start22/base22: frame-start stream row and the ring's base row, both
    mod 2^22 (f32-exact on unbounded streams); their difference is the
    small positive ring offset.  The FSM's post-A2 schedule is rigid, so
    data positions follow _data_schedule() exactly from the frame start
    (verified per mode against the tracker's own labels)."""
    ring_t = symring.shape[1]
    rel = (start22 - base22) & ((1 << 22) - 1)
    pos0 = rel + FIRST_DATA_OFFSET
    pos = jnp.clip(pos0[:, None] + jnp.asarray(_data_schedule())[None, :],
                   0, ring_t - 1)
    return symring[ch[:, None], pos]


def decode_events_inline(symring: jax.Array, base22: jax.Array,
                         ev_table: jax.Array, e_max: int) -> jax.Array:
    """Decode up to e_max completed frames straight from the device-side
    symbol ring + event table (both already in the compute graph).

    Returns an (e_max, 2 + PACK_WORDS) int32 matrix: column 0 is the
    flat event-table row the frame came from (-1 = empty slot), column 1
    the on-device header-FCS verdict (_device_fcs_ok), the rest the
    frame's decoded bits packed LSB-first into int32 words.  Every
    mode's decoder runs on the padded event batch and the right result
    is selected per event (a data-dependent dispatch would force a host
    round trip).
    """
    from .tracker import EV_FIELDS, K_EVENTS
    c = symring.shape[0]
    tab = ev_table.reshape(c, K_EVENTS, EV_FIELDS)
    valid = tab[:, :, 0] > 0.5
    flat = jnp.nonzero(valid.ravel(), size=e_max,
                       fill_value=c * K_EVENTS)[0]
    ok = flat < c * K_EVENTS
    ch = jnp.where(ok, flat // K_EVENTS, 0)
    sl = jnp.where(ok, flat % K_EVENTS, 0)
    # padded slots get neutral parameters, not copies of row 0's event
    mode = jnp.clip(jnp.where(ok, tab[ch, sl, 1].astype(jnp.int32), 0),
                    0, len(C.MODES) - 1)
    bmask = ok & (tab[ch, sl, 2] > 0.5)
    start22 = jnp.where(ok, tab[ch, sl, 10].astype(jnp.int32), 0)
    syms = gather_event_symbols(symring, start22, base22, ch)
    per_mode = []
    for m in range(len(C.MODES)):
        p = C.MODES[m]
        bits_m = _decode_core(syms[:, :p.num_data_symbols], bmask, m)
        per_mode.append(jnp.pad(bits_m.astype(jnp.int32),
                                ((0, 0), (0, MAX_FRAMEBITS - p.framebits))))
    allbits = jnp.stack(per_mode)                  # (8, E, MAXF)
    sel = jnp.take_along_axis(
        allbits, mode[None, :, None].astype(jnp.int32), axis=0)[0]
    padded = jnp.pad(sel, ((0, 0), (0, PACK_WORDS * 32 - MAX_FRAMEBITS)))
    words = jnp.sum(
        padded.reshape(e_max, PACK_WORDS, 32)
        << jnp.arange(32, dtype=jnp.int32)[None, None, :], axis=-1)
    row = jnp.where(ok, flat, -1).astype(jnp.int32)
    fcs = _device_fcs_ok(sel).astype(jnp.int32)
    return jnp.concatenate([row[:, None], fcs[:, None], words], axis=1)


def pdu_bytes_from_bits(bits: np.ndarray) -> list[bytes]:
    """(B, framebits) bits -> list of PDU byte strings (LSB-first packing)."""
    out = []
    arr = np.asarray(bits, dtype=np.uint8)
    for row in arr:
        out.append(bytes(bitops.bits_to_bytes_lsb_first(row)))
    return out


def decode_frames(data_symbols: np.ndarray, bitmask: np.ndarray, mode: int) -> list[bytes]:
    """Convenience host wrapper: symbols -> PDU octet strings.

    The batch axis is padded to a power of two so live traffic with
    varying per-block event counts hits a bounded set of compiled shapes
    (<= 8 modes x log2(batch) sizes)."""
    syms = np.asarray(data_symbols, np.complex64)
    n = syms.shape[0]
    b = 1 << max(0, int(np.ceil(np.log2(max(1, n)))))
    syms_p = np.zeros((b, syms.shape[1]), np.complex64)
    syms_p[:n] = syms
    mask_p = np.zeros((b, 1), np.int32)
    mask_p[:n, 0] = np.asarray(bitmask).reshape(-1)
    bits = decode_frame_batch(jnp.asarray(syms_p), jnp.asarray(mask_p), mode)
    return pdu_bytes_from_bits(np.asarray(bits)[:n])
