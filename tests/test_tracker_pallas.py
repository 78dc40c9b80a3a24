"""Pallas/Triton tracker kernel vs the lax.scan reference implementation.

On the CPU the kernel runs in the Pallas interpreter, so these tests
validate the kernel's logic; the compiled Triton kernel is compared with
the scan on the GPU by chip_smoke.py (phase d).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dumphfdl_tpu import constants as C
from dumphfdl_tpu.dsp import modulator
from dumphfdl_tpu.dsp.channel import agc_block, agc_init, matched_filter
from dumphfdl_tpu.dsp.tracker import HALO, tracker_block, tracker_init
from dumphfdl_tpu.dsp.tracker_pallas import tracker_block_kernel


def kernel(*args, **kw):
    return tracker_block_kernel(*args, interpret=True, **kw)


def _assert_state_close(s1, s2, **kw):
    for f in s1._fields:
        a, b = np.asarray(getattr(s1, f)), np.asarray(getattr(s2, f))
        np.testing.assert_allclose(a, b, err_msg=f'state field {f}',
                                   rtol=kw.get('rtol', 1e-4),
                                   atol=kw.get('atol', 1e-4))


def _noise(nch, steps, seed, scale=1.0):
    T = steps * 3 + HALO
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nch, T))
         + 1j * rng.standard_normal((nch, T))).astype(np.complex64) * scale
    lvl = np.abs(rng.standard_normal((nch, T)).astype(np.float32)) + 0.5
    return jnp.asarray(x), jnp.asarray(lvl)


@pytest.mark.parametrize('tile', [2, 4])
def test_noise_block_parity(tile):
    """Several channel tiles over pure noise: state, outputs, event table
    and counters must match the scan tracker.  (Acquisition gate off:
    this pins full-trajectory parity; the gated fast path is pinned
    separately below.)"""
    nch, steps = 4, 100
    x, lvl = _noise(nch, steps, 0)
    st = tracker_init(nch)
    s1, o1, ev1, cnt1 = tracker_block(st, x, lvl, steps)
    s2, o2, ev2, cnt2 = kernel(st, x, lvl, steps, gate=False, tile=tile)
    _assert_state_close(s1, s2, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(o1.sym), np.asarray(o2.sym),
                               atol=2e-5)
    assert np.array_equal(np.asarray(o1.is_data), np.asarray(o2.is_data))
    assert np.array_equal(np.asarray(o1.data_idx), np.asarray(o2.data_idx))
    assert np.array_equal(np.asarray(o1.frame_parity),
                          np.asarray(o2.frame_parity))
    np.testing.assert_array_equal(np.asarray(ev1), np.asarray(ev2))
    np.testing.assert_array_equal(np.asarray(cnt1), np.asarray(cnt2))


def test_window_roundtrip():
    """The kernel's 4-word bit register carries the scan's (C, 127)
    bipolar window exactly, both ways."""
    from dumphfdl_tpu.dsp.tracker_pallas import _pack_state, _unpack_state
    rng = np.random.default_rng(4)
    st = tracker_init(5)
    win = 1.0 - 2.0 * rng.integers(0, 2, (5, C.A_LEN)).astype(np.float32)
    st = st._replace(window=jnp.asarray(win))
    back = _unpack_state(*_pack_state(st, 8), 5)
    np.testing.assert_array_equal(np.asarray(back.window), win)
    np.testing.assert_array_equal(np.asarray(back.eq_taps),
                                  np.asarray(st.eq_taps))


@pytest.mark.slow
def test_frame_decode_parity():
    """A full mode-1 frame with CFO + timing offset, processed in two
    blocks (state carry across the halo): both implementations must
    produce the same completion event and near-identical symbols."""
    rng = np.random.default_rng(5)
    pdu = modulator.make_test_mpdu(1, rng, icao=0x3C0001)
    syms = modulator.frame_symbols(pdu, 1)
    iq = modulator.synthesize_iq(
        syms, imp=modulator.Impairments(snr_db=30.0, cfo_hz=12.0,
                                        timing_offset=0.4, seed=3))
    n = len(iq)
    noise = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.01
    x = np.stack([iq, noise]).astype(np.complex64)
    blk = (n // 2 // 3) * 3

    def run(tb):
        ast = agc_init(2)
        tst = tracker_init(2)
        tail = jnp.zeros((2, HALO), jnp.complex64)
        ltail = jnp.ones((2, HALO), jnp.float32)
        evs, syms_out = [], []
        for off in (0, blk):
            ast, y, lv = agc_block(ast, jnp.asarray(x[:, off:off + blk]))
            mf = matched_filter(y)
            mfe = jnp.concatenate([tail, mf], axis=1)
            lve = jnp.concatenate([ltail, lv], axis=1)
            tail, ltail = mfe[:, -HALO:], lve[:, -HALO:]
            tst, outs, ev, cnt = tb(tst, mfe, lve, blk // 3)
            evs.append(np.asarray(ev))
            syms_out.append(np.asarray(outs.sym))
        return np.concatenate(evs), tst, np.concatenate(syms_out)

    ev1, st1, sym1 = run(tracker_block)
    ev2, st2, sym2 = run(lambda *a: kernel(*a, gate=False, tile=2))
    # one completed frame on channel 0, none on the noise channel
    assert (ev1[:, 0] > 0.5).sum() == 1
    np.testing.assert_allclose(ev1, ev2, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sym1, sym2, atol=1e-4)
    _assert_state_close(st1, st2)


def test_debug_taps_parity():
    """debug_taps=True emits the same per-symbol loop internals (costas
    dphi / phase error / timing fraction) from both implementations."""
    nch, steps = 2, 64
    x, lvl = _noise(nch, steps, 7)
    st = tracker_init(nch)
    _, o1, _, _ = tracker_block(st, x, lvl, steps, debug_taps=True)
    _, o2, _, _ = kernel(st, x, lvl, steps, True, tile=2)
    assert o1.taps is not None and o2.taps is not None
    np.testing.assert_allclose(np.asarray(o1.taps), np.asarray(o2.taps),
                               rtol=2e-5, atol=2e-5)


def test_channel_step_dispatch_uses_pallas():
    """ChannelBank(tracker='interpret') routes channel_step through the
    kernel and still decodes."""
    from dumphfdl_tpu.dsp.channel import ChannelBank
    rng = np.random.default_rng(1)
    pdu = modulator.make_test_mpdu(0, rng, icao=0x3C0002)
    syms = modulator.frame_symbols(pdu, 0)
    iq = modulator.synthesize_iq(
        syms, imp=modulator.Impairments(snr_db=30.0, seed=2))
    n = (len(iq) // 3) * 3
    bank = ChannelBank(1, auto_shard=False, tracker='interpret')
    events = bank.process(iq[None, :n])
    # flush silence so the final EQ-train period completes
    pad = np.zeros((1, 3 * C.T_LEN * 4), np.complex64)
    events += bank.process(pad)
    assert any(e.pdu for e in events)
    ev = next(e for e in events if e.pdu)
    assert ev.mode == 0 and ev.pdu == pdu


# ---- block-parallel acquisition gate ----

def test_acq_prefilter_detects_and_rejects():
    """acq_hits: >= 0.87 stat on real frames at 3 dB SNR / +-60 Hz CFO,
    noise well under the 0.5 threshold."""
    from dumphfdl_tpu.dsp.tracker_pallas import acq_hits
    rng = np.random.default_rng(11)
    pdu = modulator.make_test_mpdu(0, rng)
    syms = modulator.frame_symbols(pdu, 0)
    iq = modulator.synthesize_iq(syms, imp=modulator.Impairments(
        snr_db=3.0, cfo_hz=45.0, timing_offset=0.3, seed=4))
    n = (len(iq) // 3) * 3
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64) * 0.1
    x = np.stack([iq[:n], noise])
    ast = agc_init(2)
    _, y, _ = agc_block(ast, jnp.asarray(x))
    mf = matched_filter(y)
    hits = np.asarray(acq_hits(mf, 0.5))
    assert hits.tolist() == [1, 0]


def test_gated_idle_parity():
    """Gated kernel on pure noise: the idle fast path must be EXACT for
    everything frame detection depends on (event table, counters, clocks,
    noise-floor EMA trajectory) vs the scan tracker; timing/costas noise
    jitter is explicitly not carried (documented no-noise limit)."""
    nch, steps = 3, 300
    x, lvl = _noise(nch, steps, 3, scale=0.2)
    st = tracker_init(nch)
    s1, o1, ev1, cnt1 = tracker_block(st, x, lvl, steps)
    s2, o2, ev2, cnt2 = kernel(st, x, lvl, steps, tile=2)
    np.testing.assert_array_equal(np.asarray(ev1), np.asarray(ev2))
    np.testing.assert_array_equal(np.asarray(cnt1), np.asarray(cnt2))
    for f in ('abs_symbol', 'out_idx', 'symbol_cnt', 'nf_clk', 'fr_state',
              'symbols_wanted', 'frame_counter'):
        np.testing.assert_array_equal(
            np.asarray(getattr(s1, f)), np.asarray(getattr(s2, f)),
            err_msg=f'state field {f}')
    np.testing.assert_allclose(np.asarray(s1.noise_floor),
                               np.asarray(s2.noise_floor), rtol=1e-6)
    # idle tau follows the nominal no-noise advance and rebases cleanly
    np.testing.assert_allclose(np.asarray(s2.tau),
                               np.asarray(st.tau), atol=1e-3)
    # no data symbols were emitted
    assert not np.asarray(o2.is_data).any()


def test_gated_mixed_tiles_decode():
    """A frame on a channel in tile 0, pure noise filling the other
    tiles: the gated kernel must decode the frame identically to the scan
    tracker while the idle tiles take the closed-form path."""
    from dumphfdl_tpu.dsp.channel import ChannelBank
    rng = np.random.default_rng(21)
    pdu = modulator.make_test_mpdu(1, rng, icao=0x3C0099)
    syms = modulator.frame_symbols(pdu, 1)
    iq = modulator.synthesize_iq(
        syms, imp=modulator.Impairments(snr_db=20.0, cfo_hz=-25.0, seed=9))
    n = (len(iq) // 3) * 3
    nch = 66                       # 5 channel tiles of 16, the last padded
    x = (rng.standard_normal((nch, n))
         + 1j * rng.standard_normal((nch, n))).astype(np.complex64) * 0.05
    x[3, :] = iq[:n]
    bank = ChannelBank(nch, auto_shard=False, tracker='interpret')
    events = bank.process(x)
    pad = np.zeros((nch, 3 * C.T_LEN * 4), np.complex64)
    events += bank.process(pad)
    events += bank.drain_events() if bank.pipeline_events else []
    good = [e for e in events if e.pdu == pdu and e.channel == 3]
    assert good, [(e.channel, e.mode) for e in events]
    assert good[0].fcs_ok


def test_sharded_bank_runs_kernel_per_shard():
    """With the channel axis sharded over a mesh, the kernel runs on each
    device's channel shard (shard_map) and decodes the same frame."""
    import jax
    from jax.sharding import Mesh
    from dumphfdl_tpu.dsp.channel import ChannelBank
    rng = np.random.default_rng(31)
    pdu = modulator.make_test_mpdu(0, rng, icao=0x3C00AA)
    iq = modulator.synthesize_iq(
        modulator.frame_symbols(pdu, 0),
        imp=modulator.Impairments(snr_db=25.0, cfo_hz=10.0, seed=5))
    n = (len(iq) // 3) * 3
    nch = 8
    x = (rng.standard_normal((nch, n))
         + 1j * rng.standard_normal((nch, n))).astype(np.complex64) * 0.05
    x[5, :] = iq[:n]
    mesh = Mesh(np.asarray(jax.devices()[:4]), ('chan',))
    bank = ChannelBank(nch, mesh=mesh, tracker='interpret')
    events = bank.process(x)
    events += bank.process(np.zeros((nch, 3 * C.T_LEN * 4), np.complex64))
    good = [e for e in events if e.pdu == pdu and e.channel == 5]
    assert good and good[0].fcs_ok, [(e.channel, e.mode) for e in events]
