"""End-to-end round trips: modulator -> decoder chains."""

import numpy as np
import pytest

from dumphfdl_tpu import constants as C
from dumphfdl_tpu.dsp import backend, modulator
from dumphfdl_tpu.dsp.channel import ChannelBank


@pytest.mark.parametrize('mode', range(8))
def test_backend_symbol_roundtrip(mode):
    """Scrambled data symbols -> backend -> PDU bytes, all modes."""
    rng = np.random.default_rng(10 + mode)
    pdu = modulator.random_pdu(mode, rng)
    syms = modulator.encode_pdu_to_data_symbols(pdu, mode)
    out = backend.decode_frames(syms[None, :], np.array([False]), mode)[0]
    assert out == pdu


def test_backend_phase_flip_and_noise():
    mode = 2  # QPSK single slot
    rng = np.random.default_rng(42)
    pdu = modulator.random_pdu(mode, rng)
    syms = modulator.encode_pdu_to_data_symbols(pdu, mode)
    # pi phase ambiguity (bitmask) plus mild AWGN
    noisy = -syms + 0.05 * (rng.standard_normal(syms.shape)
                            + 1j * rng.standard_normal(syms.shape))
    out = backend.decode_frames(noisy[None, :], np.array([True]), mode)[0]
    assert out == pdu


def _run_channel(iq: np.ndarray, num_channels: int = 1,
                 block_len: int = 5400) -> list:
    bank = ChannelBank(num_channels)
    events = []
    n = len(iq)
    for off in range(0, n, block_len):
        chunk = iq[off:off + block_len]
        if len(chunk) < block_len:
            chunk = np.pad(chunk, (0, block_len - len(chunk)))
        block = np.tile(chunk[None, :], (num_channels, 1))
        events.extend(bank.process(block))
    return events


@pytest.mark.parametrize('mode', [1, 2])
def test_channel_clean_decode(mode):
    """Full demod chain on a clean synthesized frame at 5400 sps."""
    rng = np.random.default_rng(77 + mode)
    pdu = modulator.random_pdu(mode, rng)
    syms = modulator.frame_symbols(pdu, mode)
    iq = modulator.synthesize_iq(syms, pad_symbols=(300, 300))
    events = _run_channel(iq * 0.5)
    assert len(events) == 1, f'expected 1 frame, got {len(events)}'
    ev = events[0]
    assert ev.mode == mode
    assert ev.pdu == pdu
    # training bits should be nearly clean
    assert ev.train_bad <= ev.train_total * 0.05


def demod_soft_bits(seed: int = 0, mode: int = 2):
    """Run the modulator + backend front half (scrambler flip, soft PSK
    demod, deinterleave, rate averaging) and return the Viterbi INPUT.

    Used by test_refparity.py to feed our soft bits into the reference's
    own Viterbi (cross-checks soft-bit polarity/ordering conventions).
    Returns (pdu, soft_chips, nbits, mode).
    """
    import jax
    import jax.numpy as jnp
    from dumphfdl_tpu import sequences as seq
    from dumphfdl_tpu.ops import interleave, psk

    rng = np.random.default_rng(seed)
    pdu = modulator.random_pdu(mode, rng)
    syms = modulator.encode_pdu_to_data_symbols(pdu, mode)
    p = C.MODES[mode]
    scr = seq.bipolar(seq.scrambler_for_symbols(p.num_data_symbols))
    flipped = jnp.asarray(syms * scr)
    soft = np.asarray(jax.device_get(
        psk.soft_demodulate(flipped[None, :], p.arity)))
    soft = soft.reshape(p.num_encoded_bits)
    perm = np.asarray(interleave.deinterleave_perm(mode))
    soft = soft[perm]
    if p.code_rate == 4:
        pairs = soft.reshape(-1, 2).astype(np.int32)
        a, b = pairs[:, 0], pairs[:, 1]
        soft = ((a & b) + ((a ^ b) >> 1)).astype(np.uint8)
    return pdu, soft.astype(np.uint8), p.framebits, mode


def test_event_capacity_bounds_and_fused_overflow():
    """Event-path overflow behavior (VERDICT r4 #9).

    (a) The per-channel event table (K_EVENTS=4 slots per block) cannot
        structurally overflow: every HFDL frame is >= 4219 symbols
        (single slot; hfdl.c frame geometry), so at most ONE frame can
        COMPLETE per channel within a <= 5400-symbol demod block --
        proven here from the mode table, making K_EVENTS a 4x margin,
        not a truncation risk.
    (b) The fused on-device decode capacity (fused_event_decode) CAN be
        exceeded when many channels complete frames in the same block;
        the excess must decode bit-exactly through the gather fallback
        (_decode_by_gather) and the overflow counter must stay 0.
    """
    from dumphfdl_tpu.dsp.tracker import K_EVENTS
    from dumphfdl_tpu.dsp.channel import MAX_BLOCK_SYMBOLS

    # (a) structural bound: max completions/channel/block
    min_frame = min(m.frame_len_symbols for m in C.MODES)
    assert MAX_BLOCK_SYMBOLS // min_frame + 1 <= K_EVENTS

    # (b) 12 channels, one frame each, all completing in the same block;
    # fused capacity forced to 4 -> 8 events must take the gather path
    nch = 12
    rng = np.random.default_rng(5)
    pdus, iqs = [], []
    for cidx in range(nch):
        mode = [1, 2, 3][cidx % 3]
        pdu = modulator.random_pdu(mode, rng)
        pdus.append((mode, pdu))
        syms = modulator.frame_symbols(pdu, mode)
        iqs.append(modulator.synthesize_iq(syms, pad_symbols=(100, 200)))
    n = max(len(q) for q in iqs)
    block = np.zeros((nch, n), np.complex64)
    for i, q in enumerate(iqs):
        block[i, :len(q)] = q
    bank = ChannelBank(nch, auto_shard=False, fused_event_decode=4)
    events = []
    bl = 5400 * 3
    for off in range(0, n + 2 * bl, bl):
        chunk = block[:, off:off + bl]
        if chunk.shape[1] < bl:
            chunk = np.pad(chunk, ((0, 0), (0, bl - chunk.shape[1])))
        events.extend(bank.process(chunk))
        # overflow counter (index 3) stays zero every block
        assert int(np.asarray(bank.last_counters)[:, 3].sum()) == 0
    events.extend(bank.drain_events())
    got = {e.channel: e for e in events if e.pdu is not None}
    assert len(got) == nch, sorted(got)
    for cidx, (mode, pdu) in enumerate(pdus):
        ev = got[cidx]
        assert ev.mode == mode
        assert ev.fcs_ok is not None
        assert ev.pdu[:len(pdu)] == pdu, f'channel {cidx} payload mismatch'
