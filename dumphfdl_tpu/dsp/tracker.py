"""Streaming per-channel demodulator: one fused scan over the symbol clock.

Batched redesign of the reference's per-sample decoder thread
(/root/reference/src/hfdl.c:593-935).  The reference runs one pthread per
channel, iterating sample-by-sample through liquid-dsp objects.  Here *all*
channels advance in lockstep through a single ``lax.scan`` whose carry is a
pytree of (C,)-shaped state vectors, so channel count is a batch dimension
and the sequential axis is the symbol clock (2 steps per symbol, matching
the reference's symsync output rate).

Differences from the serial design (behavior-preserving):

* Timing recovery interpolates the fully materialized, matched-filtered
  block directly (polyphase windowed-sinc bank + derivative bank with a
  maximum-likelihood timing error detector) instead of liquid's
  streaming symsync; loop constants follow hfdl.c:503-505.
* The A/M1 correlators are a (C,127)x(127,9) matmul per symbol instead of
  bsequence popcounts (hfdl.c:781,824).
* Frame payloads are not buffered in-scan: each data symbol is emitted with
  a (frame parity, slot index) label and scattered into persistent frame
  buffers afterwards (see framesink.py); training-bit errors are counted
  incrementally (hfdl.c:952-966 equivalent).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import sequences as seq

# --- framer states (hfdl.c:54-62) ---
A1_SEARCH, A2_SEARCH, M1_SEARCH, M2_SKIP, EQ_TRAIN, DATA_1, DATA_2 = range(1, 8)

# --- interpolator geometry ---
NPHASES = 32
ITAPS = 8          # interpolation taps
HALO_FRONT = 24    # window margin before the first processed sample
HALO_BACK = 12     # margin after the last processed sample
HALO = HALO_FRONT + HALO_BACK   # carried tail between blocks (36)
SLAB_BASE_OFF = HALO_FRONT - 5  # slab start for symbol t is 3*t + this

_TS_CORRECTION_SYMBOLS = C.PREKEY_LEN + 2 * C.A_LEN  # timestamp backdate (hfdl.c:658)


@functools.cache
def _interp_banks() -> tuple[np.ndarray, np.ndarray]:
    """(NPHASES+1, ITAPS) windowed-sinc interpolation + derivative banks.

    Bank p interpolates at fractional delay p/NPHASES between input samples
    ITAPS//2-1 and ITAPS//2 of the window.
    """
    h = np.zeros((NPHASES + 1, ITAPS), dtype=np.float32)
    dh = np.zeros((NPHASES + 1, ITAPS), dtype=np.float32)
    center = ITAPS // 2 - 1
    n = np.arange(ITAPS)
    for p in range(NPHASES + 1):
        mu = p / NPHASES
        t = n - (center + mu)
        w = np.kaiser(ITAPS, 6.0)
        # windowed sinc with mild rolloff to tame edge phases
        h[p] = np.sinc(t) * w
        h[p] /= h[p].sum() if abs(h[p].sum()) > 1e-6 else 1.0
        # derivative of sinc: d/dt sinc(t)
        with np.errstate(divide='ignore', invalid='ignore'):
            ds = np.where(np.abs(t) < 1e-8, 0.0,
                          (np.cos(np.pi * t) - np.sinc(t)) / t)
        dh[p] = ds * w
    return h, dh


class TrackerState(NamedTuple):
    # timing
    tau: jax.Array          # (C,) f32 position in extended input block
    rate: jax.Array         # (C,) f32 timing-loop integrator (samples/step)
    out_idx: jax.Array      # (C,) i32 symsync output index (parity = symbol strobe)
    # costas (hfdl.c:250-294)
    phi: jax.Array          # (C,) f32
    dphi: jax.Array         # (C,) f32
    # equalizer
    eq_taps: jax.Array      # (C, EQ_LEN) c64
    eq_buf: jax.Array       # (C, EQ_LEN) c64
    # bit window for A/M correlation
    window: jax.Array       # (C, 127) f32 bipolar (+1 = bit 0)
    # framer
    fr_state: jax.Array     # (C,) i32
    symbols_wanted: jax.Array  # (C,) i32
    search_retries: jax.Array  # (C,) i32
    bitmask: jax.Array      # (C,) bool
    mode: jax.Array         # (C,) i32 detected M1 match
    data_arity: jax.Array   # (C,) i32
    cur_arity: jax.Array    # (C,) i32
    data_segments_left: jax.Array  # (C,) i32
    eq_train_cnt: jax.Array  # (C,) i32
    t_idx: jax.Array        # (C,) i32
    data_idx: jax.Array     # (C,) i32 next data-symbol slot
    frame_counter: jax.Array  # (C,) i32
    symbol_cnt: jax.Array   # (C,) i32 watchdog counter
    abs_symbol: jax.Array   # (C,) i64-ish i32 absolute symbol index
    frame_start_sym: jax.Array  # (C,) i32
    train_bad: jax.Array    # (C,) i32
    train_total: jax.Array  # (C,) i32
    # measurements
    freq_err: jax.Array     # (C,) f32
    signal_level: jax.Array  # (C,) f32
    frame_sym_cnt: jax.Array  # (C,) f32
    noise_floor: jax.Array  # (C,) f32
    nf_clk: jax.Array       # (C,) i32
    # block-parallel acquisition carry (tracker kernel): 1 = the
    # preamble prefilter saw A-sequence energy in the PREVIOUS block, so
    # the next block must run the full symbol loop even if the channel
    # is still hunting (a frame may straddle the boundary).  The scan
    # tracker ignores and passes it through.
    acq_hit: jax.Array = None  # (C,) i32


class TrackerOutputs(NamedTuple):
    """Per-symbol, per-channel scan outputs; axes (T_out, C).

    Frame-completion events and preamble counters are accumulated in the
    scan carry (dense per-step event fields would triple the scan output
    bandwidth); tracker_block returns them separately."""
    sym: jax.Array          # c64 equalized symbol
    is_data: jax.Array      # bool
    data_idx: jax.Array     # i32 slot within frame
    frame_parity: jax.Array  # i32 frame_counter & 1
    # optional per-symbol loop internals for --datadumps (costas dphi,
    # costas phase error, symsync fractional timing); None unless the
    # block ran with debug_taps=True (dumpfile.c COSTAS/SYMSYNC taps)
    taps: object = None     # (T, C, 3) f32 | None


# lax.scan unroll of the symbol loop (tracker_block); fastest of 1, 4, 8 on
# the H100 (PERF.md)
SCAN_UNROLL = 4

# event-table geometry shared with dsp/channel.py
K_EVENTS = 4
EV_FIELDS = 11   # valid, mode, bitmask, parity, freq_err, rssi, nf,
                 # train_bad, train_total, start_sym, start_sym mod 2^22
                 # (field 10 stays f32-exact on unbounded streams; field 9
                 # loses integer exactness past 2^24 symbols ~ 2.6 h and
                 # is only used for display timestamps)


def _init_eq_taps() -> np.ndarray:
    """Initial equalizer: near-Nyquist lowpass == pass-through with delay
    (liquid eqlms_cccf_create_lowpass(15, 0.45), hfdl.c:495)."""
    n = np.arange(C.EQ_LEN) - (C.EQ_LEN - 1) / 2
    h = 2 * 0.45 * np.sinc(2 * 0.45 * n) * np.hamming(C.EQ_LEN)
    h = h / h.sum()
    return h.astype(np.complex64)


def tracker_init(num_channels: int) -> TrackerState:
    c = num_channels
    z = lambda dt=jnp.int32: jnp.zeros((c,), dtype=dt)
    return TrackerState(
        tau=jnp.full((c,), float(HALO_FRONT), dtype=jnp.float32),
        rate=z(jnp.float32),
        out_idx=z(),
        phi=z(jnp.float32),
        dphi=z(jnp.float32),
        eq_taps=jnp.asarray(np.tile(_init_eq_taps()[None, :], (c, 1))),
        eq_buf=jnp.zeros((c, C.EQ_LEN), jnp.complex64),
        window=jnp.ones((c, C.A_LEN), dtype=jnp.float32),
        fr_state=jnp.full((c,), A1_SEARCH, dtype=jnp.int32),
        symbols_wanted=jnp.ones((c,), dtype=jnp.int32),
        search_retries=z(),
        bitmask=z(bool),
        mode=z(),
        data_arity=jnp.ones((c,), dtype=jnp.int32),
        cur_arity=jnp.ones((c,), dtype=jnp.int32),
        data_segments_left=z(),
        eq_train_cnt=z(),
        t_idx=z(),
        data_idx=z(),
        frame_counter=z(),
        symbol_cnt=z(),
        abs_symbol=z(),
        frame_start_sym=z(),
        train_bad=z(),
        train_total=z(),
        freq_err=z(jnp.float32),
        signal_level=jnp.full((c,), 1e-3, dtype=jnp.float32),
        frame_sym_cnt=z(jnp.float32),
        noise_floor=jnp.ones((c,), dtype=jnp.float32),
        nf_clk=z(),
        acq_hit=z(),
    )


def framer_fsm_step(*, fr, sw, retries, bitmask, mode, data_arity,
                    cur_arity, segs_left, eq_cnt, t_idx, data_idx,
                    freq_err, frame_start, sig, fsc, lvl, dphi, abs_symbol,
                    train_bad, train_total,
                    corr_a, corr_m1, m1_match, mode_lookup, as_flag):
    """Framer FSM transitions (hfdl.c:779-891) -- THE single source.

    Shared verbatim by the lax.scan tracker (this module) and the Pallas
    kernel (tracker_pallas.py): every op is elementwise on (C,) vectors
    in the scan and (tile,) vectors in the kernel, so one definition
    serves both.

    Args the two callers provide differently:
      mode_lookup: m1_match -> (segment_count, arity) per-mode values
        (table gather in the scan; select chain in the kernel).
      as_flag: bool array -> caller's bitmask dtype (bool / int32).

    Returns (updates dict, flags dict).  Callers additionally handle, per
    the flags: event emission (frame_done), counter accumulation, and the
    non-scalar parts of the framer reset (equalizer taps, timing rate).
    """
    run_fsm = sw <= 1
    sw = jnp.where(~run_fsm, sw - 1, sw)

    # --- A1 search ---
    a1_hit = run_fsm & (fr == A1_SEARCH) \
        & (jnp.abs(corr_a) > C.CORR_THRESHOLD_A1)
    bitmask = jnp.where(a1_hit, as_flag(corr_a < 0), bitmask)
    sig = jnp.where(a1_hit, lvl, sig)
    fsc = jnp.where(a1_hit, 1.0, fsc)
    retries = jnp.where(a1_hit, 0, retries)
    sw = jnp.where(a1_hit, C.A_LEN, sw)

    # --- A2 search ---
    in_a2 = run_fsm & (fr == A2_SEARCH)
    a2_hit = in_a2 & (jnp.abs(corr_a) > C.CORR_THRESHOLD_A2)
    a2_miss = in_a2 & ~a2_hit
    a2_fail = a2_miss & (retries + 1 >= C.MAX_SEARCH_RETRIES)
    retries = jnp.where(a2_miss, retries + 1, retries)
    # Reported frequency error mirrors the reference display exactly
    # (hfdl.c:812: dphi * HFDL_SYMBOL_RATE / 2pi).  NOTE: in both
    # decoders dphi is radians per *half*-symbol -- the reference's
    # costas steps once per symsync output and symsync emits 2 samples
    # per symbol (hfdl.c:505,709-710), as does our fused step (two
    # costas_step calls per symbol).  The displayed value is therefore
    # cfo/2 in BOTH decoders; we keep the formula for output parity
    # rather than "fixing" it to true CFO.
    freq_err = jnp.where(a2_hit, dphi * C.SYMBOL_RATE / (2 * np.pi),
                         freq_err)
    frame_start = jnp.where(a2_hit, abs_symbol - _TS_CORRECTION_SYMBOLS,
                            frame_start)
    sw = jnp.where(a2_hit, C.M1_LEN, sw)
    retries = jnp.where(a2_hit, 0, retries)

    # --- M1 search ---
    in_m1 = run_fsm & (fr == M1_SEARCH)
    m1_hit = in_m1 & (corr_m1 > C.CORR_THRESHOLD_M1)
    m1_fail = in_m1 & ~m1_hit
    mode = jnp.where(m1_hit, m1_match, mode)
    segs_lut, arity_lut = mode_lookup(m1_match)
    segs_left = jnp.where(m1_hit, segs_lut, segs_left)
    data_arity = jnp.where(m1_hit, arity_lut, data_arity)
    sw = jnp.where(m1_hit, C.M2_LEN, sw)
    retries = jnp.where(m1_hit, 0, retries)

    # --- M2 skip done ---
    m2_done = run_fsm & (fr == M2_SKIP)
    sw = jnp.where(m2_done, C.T_LEN, sw)
    eq_cnt = jnp.where(m2_done, C.EQ_TRAIN_SEQ_CNT, eq_cnt)
    data_idx = jnp.where(m2_done, 0, data_idx)

    # --- EQ train period complete ---
    eqt = run_fsm & (fr == EQ_TRAIN)
    more_train = eqt & (eq_cnt > 1)
    to_data = eqt & (eq_cnt <= 1) & (segs_left > 0)
    frame_done = eqt & (eq_cnt <= 1) & (segs_left <= 0)
    eq_cnt = jnp.where(more_train, eq_cnt - 1, eq_cnt)
    sw = jnp.where(more_train, C.T_LEN, sw)
    sw = jnp.where(to_data, C.DATA_FRAME_LEN // 2, sw)
    t_idx = jnp.where(more_train, 0, t_idx)
    cur_arity = jnp.where(to_data, data_arity, cur_arity)

    # --- data halves ---
    d1 = run_fsm & (fr == DATA_1)
    sw = jnp.where(d1, C.DATA_FRAME_LEN // 2, sw)
    d2 = run_fsm & (fr == DATA_2)
    segs_left = jnp.where(d2, segs_left - 1, segs_left)
    cur_arity = jnp.where(d2, 1, cur_arity)
    eq_cnt = jnp.where(d2, 1, eq_cnt)
    sw = jnp.where(d2, C.T_LEN, sw)
    t_idx = jnp.where(d2, 0, t_idx)

    # --- state transitions ---
    fr = jnp.where(a1_hit, A2_SEARCH, fr)
    fr = jnp.where(a2_hit, M1_SEARCH, fr)
    fr = jnp.where(m1_hit, M2_SKIP, fr)
    fr = jnp.where(m2_done, EQ_TRAIN, fr)
    fr = jnp.where(to_data | d1, jnp.where(d1, DATA_2, DATA_1), fr)
    fr = jnp.where(d2, EQ_TRAIN, fr)

    # event fields snapshot the values the completed frame was decoded
    # with, BEFORE the framer reset clears them
    ev_bitmask, ev_train_bad, ev_train_total = bitmask, train_bad, train_total

    # --- framer reset, scalar part (A2/M1 failure or frame completion) ---
    do_reset = a2_fail | m1_fail | frame_done
    fr = jnp.where(do_reset, A1_SEARCH, fr)
    sw = jnp.where(do_reset, 1, sw)
    retries = jnp.where(do_reset, 0, retries)
    cur_arity = jnp.where(do_reset, 1, cur_arity)
    train_bad = jnp.where(do_reset, 0, train_bad)
    train_total = jnp.where(do_reset, 0, train_total)
    t_idx = jnp.where(do_reset, 0, t_idx)
    bitmask = jnp.where(do_reset, jnp.zeros_like(bitmask), bitmask)
    data_idx = jnp.where(do_reset, 0, data_idx)

    upd = dict(fr=fr, sw=sw, retries=retries, bitmask=bitmask, mode=mode,
               data_arity=data_arity, cur_arity=cur_arity,
               segs_left=segs_left, eq_cnt=eq_cnt, t_idx=t_idx,
               data_idx=data_idx, freq_err=freq_err,
               frame_start=frame_start, sig=sig, fsc=fsc,
               train_bad=train_bad, train_total=train_total)
    flags = dict(a2_hit=a2_hit, m1_hit=m1_hit, m1_fail=m1_fail,
                 frame_done=frame_done, do_reset=do_reset,
                 ev_bitmask=ev_bitmask, ev_train_bad=ev_train_bad,
                 ev_train_total=ev_train_total)
    return upd, flags


def _demod_bits_and_err(y, arity):
    """Hard BPSK bit, and phase error for the active arity.

    Returns (bpsk_bit (C,) i32, phase_err (C,) f32) following the liquid
    modem conventions (see ops/psk.py).
    """
    theta = jnp.arctan2(y.imag, y.real)
    # phase error to nearest constellation point, per arity
    err_b = theta - jnp.round(theta / jnp.pi) * jnp.pi
    tq = theta - np.pi / 4
    err_q = tq - jnp.round(tq / (np.pi / 2)) * (np.pi / 2)
    err_8 = theta - jnp.round(theta / (np.pi / 4)) * (np.pi / 4)
    err = jnp.where(arity == 1, err_b, jnp.where(arity == 2, err_q, err_8))
    bit = (y.real < 0).astype(jnp.int32)
    return bit, err


@functools.partial(jax.jit,
                   static_argnames=('num_steps', 'debug_taps', 'unroll'))
def tracker_block(state: TrackerState,
                  x: jax.Array,
                  level: jax.Array,
                  num_steps: int,
                  debug_taps: bool = False,
                  unroll: int = SCAN_UNROLL,
                  ) -> tuple[TrackerState, TrackerOutputs]:
    """Run the tracker over one block.

    Args:
      state: carried TrackerState.
      x: (C, T) matched-filtered complex input at 5400 sps, *including* the
         HALO samples carried from the previous block at the front.
      level: (C, T) AGC signal-level estimate aligned with x.
      num_steps: symbol iterations to run (~(T - 2*HALO) / 3).
      unroll: scan unroll factor (reduced to a divisor of num_steps).

    Returns (new_state, outputs); new_state.tau is rebased for the next
    block (caller prepends the last HALO samples of x).
    """
    h_np, dh_np = _interp_banks()
    h_bank = jnp.asarray(h_np)
    dh_bank = jnp.asarray(dh_np)
    a_bip = jnp.asarray(seq.bipolar(seq.a_bits()))             # (127,)
    m1_bip = jnp.asarray(seq.bipolar(seq.m1_bits_all())).T     # (127, 8)
    t_bits = jnp.asarray(seq.t_bits(), dtype=jnp.int32)        # (15,)
    t_bip = jnp.asarray(seq.bipolar(seq.t_bits()))             # (15,)
    mode_segments = jnp.asarray([m.data_segment_cnt for m in C.MODES], jnp.int32)
    mode_arity = jnp.asarray([m.arity for m in C.MODES], jnp.int32)

    T = x.shape[1]
    cidx = jnp.arange(x.shape[0])

    # ---- per-block channel alignment -------------------------------------
    # One per-channel gather per BLOCK aligns every channel's timing offset
    # to ~0, so the in-scan interpolator reads a single shared slab per
    # symbol (scalar-index dynamic slice) instead of per-channel gathers
    # inside the loop.
    SLAB = 16
    shift = jnp.clip(jnp.round(state.tau).astype(jnp.int32) - HALO_FRONT,
                     -8, 8)
    x_pad = jnp.pad(x, ((0, 0), (8, SLAB)))
    lvl_pad = jnp.pad(level, ((0, 0), (8, SLAB)), mode='edge')
    t_al = T + 8
    x_al = jax.vmap(lambda row, sh: jax.lax.dynamic_slice(
        row, (sh + 8,), (t_al,)))(x_pad, shift)
    lvl_al = jax.vmap(lambda row, sh: jax.lax.dynamic_slice(
        row, (sh + 8,), (t_al,)))(lvl_pad, shift)
    state = state._replace(tau=state.tau - shift.astype(jnp.float32))

    base_step = C.SPS / C.SYMSYNC_OUT_RATE      # 1.5 input samples per step
    # 2nd-order timing loop gains from loop bw (symsync_crcf_set_lf_bw 0.001)
    bw = C.SYMSYNC_LOOP_BW
    zeta = 1.0 / np.sqrt(2.0)
    denom = 1 + 2 * zeta * bw + bw * bw
    k1 = 4 * zeta * bw / denom
    k2 = 4 * bw * bw / denom

    phase_iota = jnp.arange(NPHASES + 1, dtype=jnp.int32)[None, :]  # (1, 33)
    lane_iota = jnp.arange(SLAB, dtype=jnp.int32)[None, :]          # (1, 16)

    def taps_for(phase, bank):
        """(C,) phase indices -> (C, ITAPS) taps via one-hot matmul (at
        full f32: a one-hot product is an exact row selection only if the
        taps are not rounded to TF32)."""
        oh = (phase[:, None] == phase_iota).astype(jnp.float32)     # (C, 33)
        return jnp.matmul(oh, bank, precision=jax.lax.Precision.HIGHEST)

    def interp_slab(tau, slab, base, want_deriv):
        """Interpolate every channel at its own tau from the shared slab."""
        i = jnp.floor(tau).astype(jnp.int32)
        mu = tau - i.astype(jnp.float32)
        off = jnp.clip(i - base, 3, 8)                              # (C,)
        phase = jnp.round(mu * NPHASES).astype(jnp.int32)
        taps = taps_for(phase, h_bank)                              # (C, 8)
        w16 = jnp.zeros(slab.shape, jnp.float32)
        start = (off - 3)[:, None]
        for j in range(ITAPS):
            w16 = jnp.where(lane_iota == start + j, taps[:, j:j + 1], w16)
        y = jnp.sum(slab * w16, axis=-1)
        if not want_deriv:
            return y
        dtaps = taps_for(phase, dh_bank)
        dw16 = jnp.zeros(slab.shape, jnp.float32)
        for j in range(ITAPS):
            dw16 = jnp.where(lane_iota == start + j, dtaps[:, j:j + 1], dw16)
        ydot = jnp.sum(slab * dw16, axis=-1)
        return y, ydot

    def step(carry, t):
        """One full symbol: even half-step (timing strobe) + odd half-step
        (demod).  Fusing both halves halves the scan length and drops the
        per-step parity masking (reference processes them serially at
        hfdl.c:708-718)."""
        st, carry_aux = carry
        # shared slab for this symbol: covers both half-step windows for
        # every channel (alignment keeps per-channel offsets within +-2)
        base = 3 * t + SLAB_BASE_OFF
        slab = jax.lax.dynamic_slice(x_al, (0, base), (x_al.shape[0], SLAB))
        # ===== even half-step: interpolate, ML TED, costas step, EQ push ===
        # The TED strobes EVEN output steps: the initial equalizer's 7-step
        # (odd) group delay maps odd-step demod onto even-step samples, so
        # even steps must sit on the matched-filter peaks (mirrors the
        # liquid symsync + eqlms delay chain of the reference).
        y_e, ydot = interp_slab(st.tau, slab, base, True)
        q = jnp.clip(y_e.real * ydot.real + y_e.imag * ydot.imag, -1.0, 1.0)
        rate = st.rate + k2 * q
        tau_o = st.tau + base_step + k1 * q + rate

        def costas_step(phi, dphi):
            phi = phi + dphi
            return jnp.where(phi > np.pi, phi - 2 * np.pi,
                             jnp.where(phi < -np.pi, phi + 2 * np.pi, phi))

        phi = costas_step(st.phi, st.dphi)
        v_e = y_e * jnp.exp(-1j * phi)
        # costas runaway watchdog during search (hfdl.c:711-715)
        runaway = (jnp.abs(st.dphi) > C.COSTAS_DPHI_RESET_LIMIT) & (st.fr_state == A1_SEARCH)
        phi = jnp.where(runaway, 0.0, phi)
        dphi = jnp.where(runaway, 0.0, st.dphi)
        rate = jnp.where(runaway, 0.0, rate)
        # ===== odd half-step: interpolate, costas, EQ push, demod ==========
        y_o = interp_slab(tau_o, slab, base, False)
        tau_next = tau_o + base_step + rate
        phi = costas_step(phi, dphi)
        v_o = y_o * jnp.exp(-1j * phi)
        # AGC level at the shared slab center (level varies over ~100
        # samples; the +-2 sample approximation is negligible)
        lvl = jax.lax.dynamic_slice(lvl_al, (0, base + 6),
                                    (x_al.shape[0], 1))[:, 0]
        eq_buf = jnp.concatenate([st.eq_buf[:, 2:], v_e[:, None],
                                  v_o[:, None]], axis=1)

        # ---- symbol processing (every iteration is a symbol now) ----
        y_eq = jnp.sum(st.eq_taps * eq_buf, axis=-1)
        bit_raw, perr = _demod_bits_and_err(y_eq, st.cur_arity)
        # costas adjust from demod phase error (hfdl.c:276-281,737-738)
        err = jnp.clip(perr, -1.0, 1.0)
        phi = phi + C.COSTAS_ALPHA * err
        dphi = dphi + C.COSTAS_BETA * err

        # EQ training (hfdl.c:730-733)
        in_train = st.fr_state == EQ_TRAIN
        t_i = jnp.clip(st.t_idx, 0, C.T_LEN - 1)
        d = t_bip[t_i] * jnp.where(st.bitmask, -1.0, 1.0)
        e = d - y_eq
        den = jnp.sum(jnp.abs(eq_buf) ** 2, axis=-1) + 1e-6
        upd = (C.EQ_BANDWIDTH * e / den)[:, None] * jnp.conj(eq_buf)
        eq_taps = jnp.where(in_train[:, None], st.eq_taps + upd, st.eq_taps)
        t_idx = jnp.where(in_train, st.t_idx + 1, st.t_idx)

        # training-bit error count (hfdl.c:952-966, incremental)
        tbit = bit_raw ^ st.bitmask.astype(jnp.int32)
        t_err = (tbit != t_bits[t_i]).astype(jnp.int32)
        train_bad = st.train_bad + jnp.where(in_train, t_err, 0)
        train_total = st.train_total + jnp.where(in_train, 1, 0)

        # bit window push during bit-emitting states
        emit_bits = st.fr_state <= M1_SEARCH
        wbit = 1.0 - 2.0 * jnp.asarray(tbit, jnp.float32)  # bit^bitmask, bipolar
        window = jnp.where(
            emit_bits[:, None],
            jnp.concatenate([st.window[:, 1:], wbit[:, None]], axis=1),
            st.window)

        # data symbol emission
        in_data = (st.fr_state == DATA_1) | (st.fr_state == DATA_2)
        out_data_idx = st.data_idx
        data_idx = jnp.where(in_data, st.data_idx + 1, st.data_idx)
        out_idx = st.out_idx + 2

        # signal level averaging inside a frame (hfdl.c:766-773)
        in_frame = st.fr_state > A1_SEARCH
        sig = jnp.where(
            in_frame,
            (st.signal_level * st.frame_sym_cnt + lvl) / (st.frame_sym_cnt + 1.0),
            st.signal_level)
        frame_sym_cnt = jnp.where(in_frame, st.frame_sym_cnt + 1.0, st.frame_sym_cnt)

        # noise floor EMA while hunting (hfdl.c:699-706); cadence ~256 input samples
        nf_clk = st.nf_clk + 1
        nf_due = (nf_clk >= 85) & (st.fr_state == A1_SEARCH)
        nf = jnp.where(
            nf_due,
            0.65 * st.noise_floor + 0.35 * jnp.minimum(st.noise_floor, lvl) + 1e-6,
            st.noise_floor)
        nf_clk = jnp.where(nf_due, 0, nf_clk)

        abs_symbol = st.abs_symbol + 1
        symbol_cnt = st.symbol_cnt + 1
        # long-hunt watchdog (hfdl.c:746-752)
        stale = (symbol_cnt >= C.MAX_SYMBOLS_WITHOUT_FRAME) & (st.fr_state == A1_SEARCH)
        phi = jnp.where(stale, 0.0, phi)
        dphi = jnp.where(stale, 0.0, dphi)
        rate = jnp.where(stale, 0.0, rate)
        symbol_cnt = jnp.where(stale, 0, symbol_cnt)

        # ---- framer FSM (shared single-source logic) ----
        # +-1 products summed at full f32: exact integers, so the
        # threshold tests match the kernel's popcount correlators exactly
        corr_a = jnp.matmul(window, a_bip,
                            precision=jax.lax.Precision.HIGHEST) / C.A_LEN
        # the 8-way M1 correlation only matters while some channel is in
        # M1 search (127 symbols per frame); skip the matmul otherwise
        any_m1 = jnp.any(st.fr_state == M1_SEARCH)

        def with_m1(w):
            corr_m = jnp.abs(jnp.matmul(
                w, m1_bip, precision=jax.lax.Precision.HIGHEST) / C.A_LEN)
            return (jnp.argmax(corr_m, axis=1).astype(jnp.int32),
                    jnp.max(corr_m, axis=1))

        def no_m1(w):
            c = w.shape[0]
            return (jnp.zeros((c,), jnp.int32), jnp.zeros((c,), jnp.float32))

        m1_match, corr_m1 = jax.lax.cond(any_m1, with_m1, no_m1, window)

        upd, flags = framer_fsm_step(
            fr=st.fr_state, sw=st.symbols_wanted, retries=st.search_retries,
            bitmask=st.bitmask, mode=st.mode, data_arity=st.data_arity,
            cur_arity=st.cur_arity, segs_left=st.data_segments_left,
            eq_cnt=st.eq_train_cnt, t_idx=t_idx, data_idx=data_idx,
            freq_err=st.freq_err, frame_start=st.frame_start_sym,
            sig=sig, fsc=frame_sym_cnt, lvl=lvl, dphi=dphi,
            abs_symbol=abs_symbol,
            train_bad=train_bad, train_total=train_total,
            corr_a=corr_a, corr_m1=corr_m1, m1_match=m1_match,
            mode_lookup=lambda m: (mode_segments[m], mode_arity[m]),
            as_flag=lambda b: b)

        # --- frame completion event -> carried event table ---
        emit = flags['frame_done']
        ev_table, ev_count, counters = carry_aux
        fields = jnp.stack([
            jnp.ones_like(upd['freq_err']),
            upd['mode'].astype(jnp.float32),
            flags['ev_bitmask'].astype(jnp.float32),
            (st.frame_counter % C.FRAME_PARITY_SLOTS).astype(jnp.float32),
            upd['freq_err'], upd['sig'], nf,
            flags['ev_train_bad'].astype(jnp.float32),
            flags['ev_train_total'].astype(jnp.float32),
            upd['frame_start'].astype(jnp.float32),
            (upd['frame_start'] & ((1 << 22) - 1)).astype(jnp.float32),
        ], axis=-1)                                   # (C, EV_FIELDS)
        slot = jnp.where(emit, jnp.minimum(ev_count, K_EVENTS), K_EVENTS)
        ev_table = ev_table.at[cidx, slot].set(
            jnp.where(emit[:, None], fields, ev_table[cidx, slot]))
        ev_count = ev_count + emit.astype(jnp.int32)
        # a frame completing after the table is full lands in the overflow
        # slot (index K_EVENTS) and is lost; count it so the host can surface
        # the drop instead of silently swallowing the frame
        ev_dropped = emit & (ev_count > K_EVENTS)
        counters = counters + jnp.stack(
            [flags['a2_hit'], flags['m1_hit'], flags['m1_fail'], ev_dropped],
            axis=-1).astype(jnp.float32)
        carry_aux_new = (ev_table, ev_count, counters)
        frame_counter = jnp.where(emit, st.frame_counter + 1, st.frame_counter)
        symbol_cnt = jnp.where(emit, 0, symbol_cnt)

        # --- framer reset, non-scalar part (the FSM resets the scalars) ---
        do_reset = flags['do_reset']
        eq_taps = jnp.where(do_reset[:, None],
                            jnp.asarray(_init_eq_taps())[None, :], eq_taps)
        rate = jnp.where(do_reset, 0.0, rate)  # sampler_reset -> symsync reset

        new_state = TrackerState(
            tau=tau_next, rate=rate, out_idx=out_idx,
            phi=phi, dphi=dphi,
            eq_taps=eq_taps, eq_buf=eq_buf, window=window,
            fr_state=upd['fr'], symbols_wanted=upd['sw'],
            search_retries=upd['retries'],
            bitmask=upd['bitmask'], mode=upd['mode'],
            data_arity=upd['data_arity'],
            cur_arity=upd['cur_arity'], data_segments_left=upd['segs_left'],
            eq_train_cnt=upd['eq_cnt'], t_idx=upd['t_idx'],
            data_idx=upd['data_idx'],
            frame_counter=frame_counter, symbol_cnt=symbol_cnt,
            abs_symbol=abs_symbol, frame_start_sym=upd['frame_start'],
            train_bad=upd['train_bad'], train_total=upd['train_total'],
            freq_err=upd['freq_err'], signal_level=upd['sig'],
            frame_sym_cnt=upd['fsc'],
            noise_floor=nf, nf_clk=nf_clk,
            acq_hit=st.acq_hit,
        )
        outputs = TrackerOutputs(
            sym=y_eq, is_data=in_data, data_idx=out_data_idx,
            frame_parity=st.frame_counter % C.FRAME_PARITY_SLOTS,
            taps=(jnp.stack([dphi, err, st.tau - jnp.floor(st.tau)], axis=-1)
                  if debug_taps else None),
        )
        return (new_state, carry_aux_new), outputs

    c = x.shape[0]
    ev_table0 = jnp.zeros((c, K_EVENTS + 1, EV_FIELDS), jnp.float32)
    ev_count0 = jnp.zeros((c,), jnp.int32)
    counters0 = jnp.zeros((c, 4), jnp.float32)
    unroll = max(1, min(unroll, num_steps))
    while num_steps % unroll:
        unroll -= 1
    (final, (ev_table, _, counters)), outs = jax.lax.scan(
        step, (state, (ev_table0, ev_count0, counters0)),
        jnp.arange(num_steps, dtype=jnp.int32), unroll=unroll)
    # undo the alignment shift, then rebase tau for the next block
    # (caller prepends the last HALO samples)
    final = final._replace(
        tau=final.tau + shift.astype(jnp.float32) - (T - HALO))
    ev_out = ev_table[:, :K_EVENTS].reshape(c, K_EVENTS * EV_FIELDS)
    return final, outs, ev_out, counters


def tracker_block_auto(state: TrackerState, x: jax.Array, level: jax.Array,
                       num_steps: int, debug_taps: bool = False,
                       impl: str = 'scan', mesh=None, axes=('chan',)):
    """Implementation dispatch (the choice is made in platform.py):
    'scan' is the lax.scan tracker above, the reference; 'kernel' the
    Pallas/Triton GPU kernel (tracker_pallas.py); 'interpret' the same
    kernel in the Pallas interpreter, for CPU tests.  All share the framer
    FSM definition (framer_fsm_step above) and emit the --datadumps loop
    taps.  With a mesh the channel axis is sharded over `axes`, and the
    kernel runs per device on its channel shard (channels are
    independent; the scan is partitioned by XLA itself)."""
    if impl == 'scan':
        return tracker_block(state, x, level, num_steps, debug_taps)
    from .tracker_pallas import tracker_block_kernel
    fn = functools.partial(tracker_block_kernel, num_steps=num_steps,
                           debug_taps=debug_taps,
                           interpret=impl == 'interpret')
    if mesh is None:
        return fn(state, x, level)
    from jax.sharding import PartitionSpec as P
    chan = P(tuple(axes))
    per_sym = P(None, tuple(axes))
    outs = TrackerOutputs(sym=per_sym, is_data=per_sym, data_idx=per_sym,
                          frame_parity=per_sym,
                          taps=per_sym if debug_taps else None)
    return jax.shard_map(fn, mesh=mesh, in_specs=(chan, chan, chan),
                         out_specs=(chan, outs, chan, chan),
                         check_vma=False)(state, x, level)
