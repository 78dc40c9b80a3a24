"""Pallas (Triton) kernel for the tracker symbol loop on NVIDIA GPUs.

The ``lax.scan`` tracker (tracker.py) runs each symbol as a chain of
small XLA kernels: at ~1800 symbols per stream-second and a few KB of
C-wide vector work per kernel, the loop is bound by launch latency, not
by bandwidth or arithmetic.  This kernel keeps the WHOLE block's symbol
loop inside one GPU program:

* the grid runs over channel tiles only; each program owns ``tile``
  channels and walks all ``num_steps`` symbols in a ``fori_loop`` whose
  carry holds the complete per-channel state (timing, costas, the
  15-tap equalizer taps and delay line as separate (tile,) vectors, so
  the delay-line shift is a renaming of the carry, and the framer);
* every value in the loop is a (tile,) vector, one lane per channel: the
  interpolator reads each channel's 8 input samples straight from the
  time-major (T, C) planes and its taps from a small bank table, both as
  per-lane gathers;
* the 127-bit correlation window is a 4-word bit register, so the A and
  M1 correlators are exact integer popcounts (no matmul, no TF32);
* completed-frame events are masked scatter stores into the event
  table, done only when some channel of the tile completes a frame.

Semantics are those of tracker.tracker_block (the reference chain is
hfdl.c:685-891): both share framer_fsm_step, and the tests compare the
two on frames and noise.  The scan stays as the reference
implementation.

Acquisition gate: a channel tile in which every channel is hunting and
whose preamble prefilter saw nothing in this block or the previous one
skips the symbol loop and applies exact closed-form updates of what
frame detection depends on (see acq_hits and _idle_update).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import constants as C
from .. import sequences as seq
from .tracker import (A1_SEARCH, DATA_1, DATA_2, EQ_TRAIN, EV_FIELDS, HALO,
                      HALO_FRONT, K_EVENTS, M1_SEARCH, NPHASES, SLAB_BASE_OFF,
                      TrackerOutputs, TrackerState, _init_eq_taps,
                      _interp_banks, framer_fsm_step, tracker_init)

TILE = 16          # channels per program (one warp); see PERF.md
ITAPS = 8
SLAB = 16          # input margin the scan's slab reads need past a block

# ---- block-parallel acquisition gate ------------------------------------
#
# Idle channels (hunting, no signal) are the common case at production
# channel counts, yet the symbol loop costs the same for them as for
# channels mid-frame.  Every HFDL frame begins with 448 unmodulated
# prekey symbols and a twice-repeated 127-symbol A sequence
# (hfdl.c:36-41), i.e. ~700 symbols that are PERIODIC at a lag of 127
# symbols.  The prefilter below detects that periodicity open-loop --
# x[m] * conj(x[m + 381]) box-summed over 381 samples, normalized by
# energy -- which is immune to CFO (a constant phase on the sum) and to
# symbol timing (no symbol grid).  On synthesized frames the statistic is
# >= 0.87 at 3 dB SNR across +-60 Hz CFO, and on noise at most 0.27 over
# 512 channel-blocks; the threshold 0.5 sits well clear of both.

ACQ_LAG = 3 * C.A_LEN      # 381 samples = 127 symbols
ACQ_THRESHOLD = 0.5


def acq_hits(x: jax.Array, threshold: float = ACQ_THRESHOLD) -> jax.Array:
    """(C,) int32 preamble-energy verdict for one block of tracker input
    ((C, T) matched-filtered complex at 5400 sps)."""
    d = w = ACQ_LAG
    c, t = x.shape
    if t <= d + w + 1:          # block too short to assess: stay active
        return jnp.ones((c,), jnp.int32)
    p = x[:, :-d] * jnp.conj(x[:, d:])
    e = 0.5 * (jnp.abs(x[:, :-d]) ** 2 + jnp.abs(x[:, d:]) ** 2)
    cp = jnp.cumsum(p, axis=1)
    ce = jnp.cumsum(e, axis=1)
    num = jnp.abs(cp[:, w:] - cp[:, :-w])
    den = ce[:, w:] - ce[:, :-w]
    stat = num / (den + 1e-9)
    return (jnp.max(stat, axis=1) > threshold).astype(jnp.int32)


# ---- packed state rows ---------------------------------------------------
SF = ('tau', 'rate', 'phi', 'dphi', 'freq_err', 'signal_level',
      'frame_sym_cnt', 'noise_floor')
SI = ('fr_state', 'symbols_wanted', 'search_retries', 'bitmask', 'mode',
      'data_arity', 'cur_arity', 'data_segments_left', 'eq_train_cnt',
      't_idx', 'data_idx', 'frame_counter', 'symbol_cnt', 'abs_symbol',
      'frame_start_sym', 'train_bad', 'train_total', 'nf_clk', 'out_idx')
NEQ = C.EQ_LEN                 # 15 taps
WIN_WORDS = 4                  # 127-bit window in 4 x 32-bit words


def _i32(v: int) -> np.int32:
    """Unsigned 32-bit pattern -> int32 constant."""
    return np.int32(np.uint32(v & 0xFFFFFFFF).view(np.int32))


def _words(bits) -> list[np.int32]:
    """127 bits (index 0 = oldest window slot) -> 4 int32 words, bit i in
    word i // 32 at position i % 32."""
    v = 0
    for i, b in enumerate(np.asarray(bits, np.int64)):
        v |= int(b) << i
    return [_i32(v >> (32 * k)) for k in range(WIN_WORDS)]


@functools.cache
def _corr_words():
    return (_words(seq.a_bits()),
            [_words(seq.m1_bits(m)) for m in range(C.M_SHIFT_CNT)])


@functools.cache
def _bank_table() -> np.ndarray:
    """(128, 8) f32: rows 0-32 the interpolation bank, rows 64-96 the
    derivative bank, indexed by phase."""
    h, dh = _interp_banks()                         # (33, 8) each
    tab = np.zeros((128, ITAPS), np.float32)
    tab[0:NPHASES + 1] = h
    tab[64:64 + NPHASES + 1] = dh
    return tab


def _rne(x):
    """Round half to even (== jnp.round) from floor, which Triton lowers."""
    f = jnp.floor(x)
    d = x - f
    odd = (f - 2.0 * jnp.floor(0.5 * f)) != 0.0
    return jnp.where((d > 0.5) | ((d == 0.5) & odd), f + 1.0, f)


def _popcount_corr(win, ref_words):
    """Bipolar correlation sum of the 127-bit window with a reference:
    127 - 2 * hamming distance, as int32."""
    pc = None
    for w, r in zip(win, ref_words):
        p = jax.lax.population_count(w ^ r)
        pc = p if pc is None else pc + p
    return C.A_LEN - 2 * pc


def _lookup(idx, values, dtype=jnp.int32):
    out = jnp.zeros(idx.shape, dtype)
    for k, v in enumerate(values):
        out = jnp.where(idx == k, v, out)
    return out


def _kernel(num_steps, tile, debug_taps, gated,
            act_ref, xre_ref, xim_ref, lvl_ref, bank_ref,
            sf0_ref, si0_ref, eq0_ref, win0_ref,
            symre_ref, symim_ref, outi_ref, sf_ref, si_ref, eq_ref, win_ref,
            ev_ref, cnt_ref, *tap_refs):
    pid = pl.program_id(0)
    c0 = pid * tile
    cs = pl.ds(c0, tile)
    cols = c0 + jnp.arange(tile, dtype=jnp.int32)
    zf = jnp.zeros((tile,), jnp.float32)
    zi = jnp.zeros((tile,), jnp.int32)

    base_step = C.SPS / C.SYMSYNC_OUT_RATE
    bw = C.SYMSYNC_LOOP_BW
    zeta = 1.0 / np.sqrt(2.0)
    denom = 1 + 2 * zeta * bw + bw * bw
    k1 = float(4 * zeta * bw / denom)
    k2 = float(4 * bw * bw / denom)
    eq_init = [float(v) for v in np.real(_init_eq_taps())]
    a_words, m1_words = _corr_words()
    mode_segs = [m.data_segment_cnt for m in C.MODES]
    mode_arity = [m.arity for m in C.MODES]

    for r in range(K_EVENTS * EV_FIELDS):
        ev_ref[r, cs] = zf

    st = {n: sf0_ref[r, cs] for r, n in enumerate(SF)}
    st.update({n: si0_ref[r, cs] for r, n in enumerate(SI)})
    st['taps_re'] = tuple(eq0_ref[k, cs] for k in range(NEQ))
    st['taps_im'] = tuple(eq0_ref[NEQ + k, cs] for k in range(NEQ))
    st['buf_re'] = tuple(eq0_ref[2 * NEQ + k, cs] for k in range(NEQ))
    st['buf_im'] = tuple(eq0_ref[3 * NEQ + k, cs] for k in range(NEQ))
    st['win'] = tuple(win0_ref[k, cs] for k in range(WIN_WORDS))
    st['ev_count'] = zi
    st['counters'] = (zi, zi, zi, zi)

    def interp(tau, base, want_deriv):
        """Interpolate every channel at its own tau: taps j = 0..7 weight
        input rows base + off - 3 + j (the scan's slab lanes)."""
        i = jnp.floor(tau).astype(jnp.int32)
        mu = tau - i.astype(jnp.float32)
        off = jnp.clip(i - base, 3, 8)
        phase = _rne(mu * NPHASES).astype(jnp.int32)
        row0 = base + off - 3
        acc = [zf] * (4 if want_deriv else 2)
        for j in range(ITAPS):
            xr = xre_ref[row0 + j, cols]
            xi = xim_ref[row0 + j, cols]
            h = bank_ref[phase, j]
            acc[0] = acc[0] + xr * h
            acc[1] = acc[1] + xi * h
            if want_deriv:
                dh = bank_ref[phase + 64, j]
                acc[2] = acc[2] + xr * dh
                acc[3] = acc[3] + xi * dh
        return tuple(acc)

    def costas_step(phi, dphi):
        phi = phi + dphi
        return jnp.where(phi > np.pi, phi - 2 * np.pi,
                         jnp.where(phi < -np.pi, phi + 2 * np.pi, phi))

    def body(t, s):
        base = 3 * t + SLAB_BASE_OFF
        fr_in = s['fr_state']
        tau = s['tau']
        # ===== even half-step: interpolate, ML TED, costas step ========
        ye_re, ye_im, yd_re, yd_im = interp(tau, base, True)
        q = jnp.clip(ye_re * yd_re + ye_im * yd_im, -1.0, 1.0)
        rate = s['rate'] + k2 * q
        tau_o = tau + base_step + k1 * q + rate
        phi = costas_step(s['phi'], s['dphi'])
        ce, se = jnp.cos(phi), jnp.sin(phi)
        ve_re = ye_re * ce + ye_im * se            # y * exp(-i phi)
        ve_im = ye_im * ce - ye_re * se
        runaway = (jnp.abs(s['dphi']) > C.COSTAS_DPHI_RESET_LIMIT) \
            & (fr_in == A1_SEARCH)
        phi = jnp.where(runaway, 0.0, phi)
        dphi = jnp.where(runaway, 0.0, s['dphi'])
        rate = jnp.where(runaway, 0.0, rate)
        # ===== odd half-step ===========================================
        yo_re, yo_im = interp(tau_o, base, False)
        tau_next = tau_o + base_step + rate
        phi = costas_step(phi, dphi)
        co, so = jnp.cos(phi), jnp.sin(phi)
        vo_re = yo_re * co + yo_im * so
        vo_im = yo_im * co - yo_re * so
        lvl = lvl_ref[t, cs]

        # equalizer delay line: shift by 2, push v_e then v_o
        bre = s['buf_re'][2:] + (ve_re, vo_re)
        bim = s['buf_im'][2:] + (ve_im, vo_im)
        tre, tim = s['taps_re'], s['taps_im']

        # ---- symbol processing ----
        yq_re = zf
        yq_im = zf
        den = zf
        for k in range(NEQ):
            yq_re = yq_re + (tre[k] * bre[k] - tim[k] * bim[k])
            yq_im = yq_im + (tre[k] * bim[k] + tim[k] * bre[k])
            den = den + (bre[k] * bre[k] + bim[k] * bim[k])
        theta = jnp.arctan2(yq_im, yq_re)
        arity = s['cur_arity']
        err_b = theta - _rne(theta / np.pi) * np.pi
        tq = theta - np.pi / 4
        err_q = tq - _rne(tq / (np.pi / 2)) * (np.pi / 2)
        err_8 = theta - _rne(theta / (np.pi / 4)) * (np.pi / 4)
        perr = jnp.where(arity == 1, err_b,
                         jnp.where(arity == 2, err_q, err_8))
        bit_raw = (yq_re < 0).astype(jnp.int32)
        err = jnp.clip(perr, -1.0, 1.0)
        phi = phi + C.COSTAS_ALPHA * err
        dphi = dphi + C.COSTAS_BETA * err

        # EQ training (hfdl.c:730-733)
        in_train = fr_in == EQ_TRAIN
        t_i = jnp.clip(s['t_idx'], 0, C.T_LEN - 1)
        t_bit = jax.lax.shift_right_logical(
            jnp.full((tile,), C.T_BITS_VALUE, jnp.int32),
            C.T_LEN - 1 - t_i) & 1
        bitmask = s['bitmask']
        d_re = (1.0 - 2.0 * t_bit.astype(jnp.float32)) \
            * jnp.where(bitmask != 0, -1.0, 1.0)
        e_re = d_re - yq_re
        e_im = -yq_im
        den = den + 1e-6
        g_re = C.EQ_BANDWIDTH * e_re / den
        g_im = C.EQ_BANDWIDTH * e_im / den
        tre = tuple(jnp.where(in_train, tre[k] + (g_re * bre[k] + g_im * bim[k]),
                              tre[k]) for k in range(NEQ))
        tim = tuple(jnp.where(in_train, tim[k] + (g_im * bre[k] - g_re * bim[k]),
                              tim[k]) for k in range(NEQ))
        t_idx = jnp.where(in_train, s['t_idx'] + 1, s['t_idx'])

        # training-bit error count
        tbit = bit_raw ^ (bitmask != 0).astype(jnp.int32)
        t_err = (tbit != t_bit).astype(jnp.int32)
        train_bad = s['train_bad'] + jnp.where(in_train, t_err, 0)
        train_total = s['train_total'] + jnp.where(in_train, 1, 0)

        # bit window push during bit-emitting states: drop the oldest bit
        # (bit 0), append tbit as bit 126
        emit_bits = fr_in <= M1_SEARCH
        w = s['win']
        sh = [jax.lax.shift_right_logical(w[k], 1)
              | jax.lax.shift_left(w[k + 1], 31) for k in range(3)]
        sh.append(jax.lax.shift_right_logical(w[3], 1)
                  | jax.lax.shift_left(tbit, 30))
        win = tuple(jnp.where(emit_bits, sh[k], w[k]) for k in range(4))

        # data symbol emission
        in_data = (fr_in == DATA_1) | (fr_in == DATA_2)
        out_data_idx = s['data_idx']
        data_idx = jnp.where(in_data, out_data_idx + 1, out_data_idx)

        # signal level averaging inside a frame
        in_frame = fr_in > A1_SEARCH
        fsc = s['frame_sym_cnt']
        sig0 = s['signal_level']
        sig = jnp.where(in_frame, (sig0 * fsc + lvl) / (fsc + 1.0), sig0)
        fsc = jnp.where(in_frame, fsc + 1.0, fsc)

        # noise floor EMA while hunting
        nf_clk = s['nf_clk'] + 1
        nf_due = (nf_clk >= 85) & (fr_in == A1_SEARCH)
        nf0 = s['noise_floor']
        nf = jnp.where(nf_due,
                       0.65 * nf0 + 0.35 * jnp.minimum(nf0, lvl) + 1e-6, nf0)
        nf_clk = jnp.where(nf_due, 0, nf_clk)

        abs_symbol = s['abs_symbol'] + 1
        symbol_cnt = s['symbol_cnt'] + 1
        stale = (symbol_cnt >= C.MAX_SYMBOLS_WITHOUT_FRAME) \
            & (fr_in == A1_SEARCH)
        phi = jnp.where(stale, 0.0, phi)
        dphi = jnp.where(stale, 0.0, dphi)
        rate = jnp.where(stale, 0.0, rate)
        symbol_cnt = jnp.where(stale, 0, symbol_cnt)

        # ---- correlators: exact integer popcounts ----
        corr_a = _popcount_corr(win, a_words).astype(jnp.float32) / C.A_LEN
        corr_m1 = None
        m1_match = zi
        for m, ref_words in enumerate(m1_words):
            cm = jnp.abs(_popcount_corr(win, ref_words))
            if corr_m1 is None:
                corr_m1 = cm
            else:
                better = cm > corr_m1
                m1_match = jnp.where(better, m, m1_match)
                corr_m1 = jnp.maximum(cm, corr_m1)
        corr_m1 = corr_m1.astype(jnp.float32) / C.A_LEN

        upd, flags = framer_fsm_step(
            fr=fr_in, sw=s['symbols_wanted'], retries=s['search_retries'],
            bitmask=bitmask, mode=s['mode'], data_arity=s['data_arity'],
            cur_arity=arity, segs_left=s['data_segments_left'],
            eq_cnt=s['eq_train_cnt'], t_idx=t_idx, data_idx=data_idx,
            freq_err=s['freq_err'], frame_start=s['frame_start_sym'],
            sig=sig, fsc=fsc, lvl=lvl, dphi=dphi, abs_symbol=abs_symbol,
            train_bad=train_bad, train_total=train_total,
            corr_a=corr_a, corr_m1=corr_m1, m1_match=m1_match,
            mode_lookup=lambda m: (_lookup(m, mode_segs),
                                   _lookup(m, mode_arity)),
            as_flag=lambda b: b.astype(jnp.int32))

        # --- frame completion event -> event table (masked scatter) ---
        emit = flags['frame_done']
        ev_count = s['ev_count']
        frame_counter = s['frame_counter']
        parity = frame_counter & (C.FRAME_PARITY_SLOTS - 1)

        def store_events():
            fields = (jnp.ones((tile,), jnp.float32),
                      upd['mode'].astype(jnp.float32),
                      flags['ev_bitmask'].astype(jnp.float32),
                      parity.astype(jnp.float32),
                      upd['freq_err'], upd['sig'], nf,
                      flags['ev_train_bad'].astype(jnp.float32),
                      flags['ev_train_total'].astype(jnp.float32),
                      upd['frame_start'].astype(jnp.float32),
                      (upd['frame_start'] & ((1 << 22) - 1))
                      .astype(jnp.float32))
            ok = emit & (ev_count < K_EVENTS)
            row0 = jnp.minimum(ev_count, K_EVENTS - 1) * EV_FIELDS
            for f, v in enumerate(fields):
                plgpu.store(ev_ref.at[row0 + f, cols], v, mask=ok)

        jax.lax.cond(jnp.max(emit.astype(jnp.int32)) > 0, store_events,
                     lambda: None)
        ev_count = ev_count + emit.astype(jnp.int32)
        ev_dropped = emit & (ev_count > K_EVENTS)
        counters = tuple(cnt + f.astype(jnp.int32) for cnt, f in zip(
            s['counters'], (flags['a2_hit'], flags['m1_hit'],
                            flags['m1_fail'], ev_dropped)))
        frame_counter_new = jnp.where(emit, frame_counter + 1, frame_counter)
        symbol_cnt = jnp.where(emit, 0, symbol_cnt)

        # --- framer reset, non-scalar part (the FSM reset the scalars) ---
        do_reset = flags['do_reset']
        tre = tuple(jnp.where(do_reset, eq_init[k], tre[k])
                    for k in range(NEQ))
        tim = tuple(jnp.where(do_reset, 0.0, tim[k]) for k in range(NEQ))
        rate = jnp.where(do_reset, 0.0, rate)

        # ---- per-symbol outputs ----
        symre_ref[t, cs] = yq_re
        symim_ref[t, cs] = yq_im
        outi_ref[t, cs] = (in_data.astype(jnp.int32) + 2 * parity
                           + 2 * C.FRAME_PARITY_SLOTS * out_data_idx)
        if debug_taps:       # --datadumps loop internals (dumpfile.c taps)
            tap_refs[0][t, cs] = dphi
            tap_refs[1][t, cs] = err
            tap_refs[2][t, cs] = tau - jnp.floor(tau)

        return dict(
            tau=tau_next, rate=rate, phi=phi, dphi=dphi,
            freq_err=upd['freq_err'], signal_level=upd['sig'],
            frame_sym_cnt=upd['fsc'], noise_floor=nf,
            fr_state=upd['fr'], symbols_wanted=upd['sw'],
            search_retries=upd['retries'], bitmask=upd['bitmask'],
            mode=upd['mode'], data_arity=upd['data_arity'],
            cur_arity=upd['cur_arity'], data_segments_left=upd['segs_left'],
            eq_train_cnt=upd['eq_cnt'], t_idx=upd['t_idx'],
            data_idx=upd['data_idx'], frame_counter=frame_counter_new,
            symbol_cnt=symbol_cnt, abs_symbol=abs_symbol,
            frame_start_sym=upd['frame_start'], train_bad=upd['train_bad'],
            train_total=upd['train_total'], nf_clk=nf_clk,
            out_idx=s['out_idx'] + 2,
            taps_re=tre, taps_im=tim, buf_re=bre, buf_im=bim, win=win,
            ev_count=ev_count, counters=counters)

    def write_state(s):
        for r, n in enumerate(SF):
            sf_ref[r, cs] = s[n]
        for r, n in enumerate(SI):
            si_ref[r, cs] = s[n]
        for k in range(NEQ):
            eq_ref[k, cs] = s['taps_re'][k]
            eq_ref[NEQ + k, cs] = s['taps_im'][k]
            eq_ref[2 * NEQ + k, cs] = s['buf_re'][k]
            eq_ref[3 * NEQ + k, cs] = s['buf_im'][k]
        for k in range(WIN_WORDS):
            win_ref[k, cs] = s['win'][k]
        for k in range(4):
            cnt_ref[k, cs] = s['counters'][k].astype(jnp.float32)

    def run_full():
        write_state(jax.lax.fori_loop(0, num_steps, body, st))

    def run_idle():
        write_state(_idle_update(st, num_steps, tile, cs, lvl_ref,
                                 (symre_ref, symim_ref, outi_ref)
                                 + tuple(tap_refs)))

    if gated:
        jax.lax.cond(act_ref[pid] != 0, run_full, run_idle)
    else:
        run_full()


def _idle_update(st, n, tile, cs, lvl_ref, step_refs):
    """Exact closed-form update of an all-hunting, no-signal tile: the
    same values as n loop iterations for everything frame detection
    depends on -- abs_symbol/out_idx clocks, the noise-floor EMA at its
    exact cadence and lvl samples, the hunt watchdog with its resets.
    tau/phi follow the no-noise limit of the loop (their noise-driven
    jitter carries no information; both trackers reset them on every
    failed acquisition anyway)."""
    base_step = C.SPS / C.SYMSYNC_OUT_RATE
    zf = jnp.zeros((tile,), jnp.float32)

    def zero_row(t, carry):
        for r in step_refs:
            r[t, cs] = zf.astype(r.dtype)
        return carry

    jax.lax.fori_loop(0, n, zero_row, None)
    s = dict(st)
    # hunt watchdog (hfdl.c:746-752): at most one crossing per block
    # (n << MAX_SYMBOLS_WITHOUT_FRAME)
    sc = s['symbol_cnt']
    sc2 = sc + n
    crossed = sc2 >= C.MAX_SYMBOLS_WITHOUT_FRAME
    s['symbol_cnt'] = jnp.where(crossed, sc2 - C.MAX_SYMBOLS_WITHOUT_FRAME,
                                sc2)
    # timing advance at the nominal rate; the carried rate holds until
    # (and unless) the watchdog zeroes it mid-block
    k_cross = jnp.clip(C.MAX_SYMBOLS_WITHOUT_FRAME - sc, 0, n) \
        .astype(jnp.float32)
    s['tau'] = s['tau'] + 2.0 * base_step * n + 2.0 * s['rate'] * k_cross
    for name in ('phi', 'dphi', 'rate'):
        s[name] = jnp.where(crossed, 0.0, s[name])
    s['abs_symbol'] = s['abs_symbol'] + n
    s['out_idx'] = s['out_idx'] + 2 * n
    # noise-floor EMA at its exact cadence (hfdl.c:699-706): update m
    # lands on symbol t_m = 85*(m+1) - nf_clk - 1, using that symbol's
    # lvl sample, exactly like the loop
    nfclk = s['nf_clk']
    cols = jnp.arange(tile, dtype=jnp.int32) + cs.start

    def ema(m, nf):
        t_m = 85 * (m + 1) - nfclk - 1
        lv = lvl_ref[jnp.clip(t_m, 0, n - 1), cols]
        return jnp.where(t_m < n,
                         0.65 * nf + 0.35 * jnp.minimum(nf, lv) + 1e-6, nf)

    s['noise_floor'] = jax.lax.fori_loop(0, n // 85 + 1, ema,
                                         s['noise_floor'])
    s['nf_clk'] = jax.lax.rem(nfclk + n, 85)
    return s


def _pack_state(state: TrackerState, c_pad: int):
    """TrackerState (C,)-vectors -> row-packed (rows, c_pad) planes."""
    c = state.tau.shape[0]
    if c_pad != c:
        state = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                             state, tracker_init(c_pad - c))
    sf = jnp.stack([getattr(state, n) for n in SF])
    si = jnp.stack([getattr(state, n).astype(jnp.int32) for n in SI])
    eq = jnp.concatenate([jnp.real(state.eq_taps).T, jnp.imag(state.eq_taps).T,
                          jnp.real(state.eq_buf).T, jnp.imag(state.eq_buf).T],
                         axis=0)
    bits = (state.window < 0).astype(jnp.uint32)                # (C, 127)
    bits = jnp.pad(bits, ((0, 0), (0, 32 * WIN_WORDS - C.A_LEN)))
    weights = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    words = jnp.sum(bits.reshape(c_pad, WIN_WORDS, 32) * weights, axis=-1,
                    dtype=jnp.uint32)
    win = jax.lax.bitcast_convert_type(words, jnp.int32).T      # (4, C)
    return sf, si, eq, win


def _unpack_state(sf, si, eq, win, c: int) -> TrackerState:
    words = jax.lax.bitcast_convert_type(win[:, :c].T, jnp.uint32)
    bits = (words[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    window = 1.0 - 2.0 * bits.reshape(c, 32 * WIN_WORDS)[:, :C.A_LEN] \
        .astype(jnp.float32)
    fields = {n: sf[r, :c] for r, n in enumerate(SF)}
    fields.update({n: si[r, :c] for r, n in enumerate(SI)})
    fields['bitmask'] = fields['bitmask'] != 0
    return TrackerState(
        eq_taps=(eq[0:NEQ, :c] + 1j * eq[NEQ:2 * NEQ, :c]).T
        .astype(jnp.complex64),
        eq_buf=(eq[2 * NEQ:3 * NEQ, :c] + 1j * eq[3 * NEQ:, :c]).T
        .astype(jnp.complex64),
        window=window, **fields)


@functools.partial(jax.jit,
                   static_argnames=('num_steps', 'debug_taps', 'interpret',
                                    'tile', 'gate'))
def tracker_block_kernel(state: TrackerState,
                         x: jax.Array,
                         level: jax.Array,
                         num_steps: int,
                         debug_taps: bool = False,
                         *,
                         interpret: bool = False,
                         tile: int = TILE,
                         gate: bool | None = None):
    """Drop-in replacement for tracker.tracker_block.

    interpret=True runs the kernel in the Pallas interpreter (CPU tests
    only); otherwise it is compiled through Triton for the GPU.  gate
    (default: on unless debug_taps) enables the acquisition gate; with it
    off every tile runs the full loop and the whole state matches the scan
    tracker, noise included."""
    if gate is None:
        gate = not debug_taps
    c = x.shape[0]
    T = x.shape[1]
    c_pad = -(-c // tile) * tile
    n_tiles = c_pad // tile
    prev = state.acq_hit if state.acq_hit is not None \
        else jnp.zeros((c,), jnp.int32)

    if gate:
        # run the loop only for tiles with a channel that is mid-frame,
        # or whose prefilter saw preamble energy in this block or the
        # previous one
        hits = acq_hits(x)
        need = (state.fr_state != A1_SEARCH).astype(jnp.int32) | hits | prev
        act = jnp.pad(need, (0, c_pad - c)).reshape(n_tiles, tile).max(axis=1)
    else:
        hits = prev          # passes through unchanged, like the scan
        act = jnp.ones((n_tiles,), jnp.int32)

    # per-block channel alignment (identical to the scan version)
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
    sf0, si0, eq0, win0 = _pack_state(state, c_pad)

    # time-major, channel-padded planes
    need_t = max(t_al, SLAB_BASE_OFF + 3 * (num_steps - 1) + SLAB)

    def to_tc(a, fill=0.0):
        return jnp.pad(a.T, ((0, need_t - t_al), (0, c_pad - c)),
                       constant_values=fill)

    xre = to_tc(jnp.real(x_al))
    xim = to_tc(jnp.imag(x_al))
    # AGC level at each symbol's slab center (base+6 = 3t+SLAB_BASE_OFF+6)
    lvl_sym = to_tc(lvl_al, 1.0)[SLAB_BASE_OFF + 6:
                                 SLAB_BASE_OFF + 6 + 3 * num_steps:3]

    plane = lambda dt: jax.ShapeDtypeStruct((num_steps, c_pad), dt)
    out_shapes = [plane(jnp.float32), plane(jnp.float32), plane(jnp.int32),
                  jax.ShapeDtypeStruct(sf0.shape, jnp.float32),
                  jax.ShapeDtypeStruct(si0.shape, jnp.int32),
                  jax.ShapeDtypeStruct(eq0.shape, jnp.float32),
                  jax.ShapeDtypeStruct(win0.shape, jnp.int32),
                  jax.ShapeDtypeStruct((K_EVENTS * EV_FIELDS, c_pad),
                                       jnp.float32),
                  jax.ShapeDtypeStruct((4, c_pad), jnp.float32)]
    if debug_taps:   # dphi, phase err, tau frac
        out_shapes += [plane(jnp.float32)] * 3
    results = pl.pallas_call(
        functools.partial(_kernel, num_steps, tile, debug_taps, gate),
        grid=(n_tiles,),
        out_shape=out_shapes,
        backend='triton',
        compiler_params=plgpu.CompilerParams(num_warps=max(1, tile // 32),
                                             num_stages=1),
        interpret=interpret,
        name='tracker_symbol_loop',
    )(act, xre, xim, lvl_sym, jnp.asarray(_bank_table()), sf0, si0, eq0,
      win0)
    sym_re, sym_im, packed, sf, si, eq, win, ev, cnt = results[:9]

    final = _unpack_state(sf, si, eq, win, c)._replace(acq_hit=hits)
    final = final._replace(
        tau=final.tau + shift.astype(jnp.float32) - (T - HALO))
    p = packed[:, :c]
    outputs = TrackerOutputs(
        sym=(sym_re[:, :c] + 1j * sym_im[:, :c]).astype(jnp.complex64),
        is_data=(p & 1) != 0,
        data_idx=p // (2 * C.FRAME_PARITY_SLOTS),
        frame_parity=(p >> 1) & (C.FRAME_PARITY_SLOTS - 1),
        taps=(jnp.stack([t[:, :c] for t in results[9:]], axis=-1)
              if debug_taps else None),
    )
    return final, outputs, ev[:, :c].T, cnt[:, :c].T
