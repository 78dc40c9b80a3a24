"""One-dispatch streaming superstep: raw SDR chunk -> frame events.

The multi-dispatch streaming loop issues ~9 host dispatches and transfers
per stream-second (upload put, packed->c64 convert, wb ring append, 2-4
channelize batches, demod step, event readback), each a host-side sync
or launch the device may wait on.  This module collapses the whole
steady state into ONE compiled program per super-block, enabled by an
exact cadence alignment: choose the demod
block length ``out`` so that

    out % SPS == 0                  (whole symbols)
    out * num % (den * post) == 0   (whole channelizer frames)

where num/den is the exact reduced fs1/5400 ratio and ``post`` the
overlap-save frames' per-frame output (fastddc geometry).  Then every
super-block consumes exactly F = out*num/(den*post) overlap-save frames
= F * input_size wideband samples, and *everything is static*:

  raw int16/uint8 words (the upload, untouched bytes)
    -> on-device format conversion (input-helpers.c:94-126 scaling)
    -> overlap-save framing from the carried tail (no ring, no cursor)
    -> lax.scan over F/SUB sub-batches of the bin-window DDC
       (frontend.ddc_frames; the scan keeps the (SUB, rows, W) working
       set bounded while amortizing ONE dispatch over ~2 s of stream)
    -> polyphase resample with STATIC coset phases (the cursor advances
       by an exact integer per block, so the per-output filter phases
       repeat block-periodically and compile to fixed slices)
    -> fused demod step (AGC -> MF -> tracker -> symbol ring -> on-device
       event decode, channel._channel_step_body)
    -> one event readout.

Steady state: one host->device put + one dispatch + one (pipelined)
readback per ~2 s super-block, independent of channel count.

The resampler introduces one block of latency: block j's demod consumes
the fs1 samples produced by block j-1 (with +-taps/2 lookahead into
block j), so the first super-block demodulates carried silence.

Reference behavior covered: input conversion input-helpers.c:94-126,
overlap-save DDC fastddc.c:46-150, msresamp-equivalent arbitrary
resampler hfdl.c:471-473, the demod chain hfdl.c:485-891.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .channel import MAX_BLOCK_SYMBOLS, _channel_step_body

# carried-state slots of SuperstepEngine._step (self is static arg 0;
# tables 1-5 are shared, not donated)
_DONATE_SS = tuple(range(6, 15))


@dataclasses.dataclass(frozen=True)
class SuperstepPlan:
    """Static cadence of one super-block."""
    out_chunk: int        # 5400-sps samples demodulated per block
    frames: int           # overlap-save frames channelized per block (F)
    sub: int              # frames per scan iteration (divisor of F)
    wb_chunk: int         # wideband samples ingested per block
    fs1_chunk: int        # fs1 samples produced per block (= F * post)

    @property
    def symbols(self) -> int:
        return self.out_chunk // C.SPS


def plan_superstep(chz, max_symbols: int = MAX_BLOCK_SYMBOLS,
                   ) -> SuperstepPlan | None:
    """Smallest aligned super-block for this channelizer geometry, or
    None when the cadence cannot align within the symbol-ring invariant
    (e.g. 2.16 Msps, whose reduced ratio 25/16 needs a 16 s block)."""
    if not chz._rs_exact:
        return None
    num, den = chz._rs_num, chz._rs_den
    post = chz.geo.post_input_size
    g = math.gcd(num, den * post)
    need = den * post // g            # out_chunk must be a multiple
    unit = need * C.SPS // math.gcd(need, C.SPS)
    if unit // C.SPS > max_symbols:
        return None
    frames = unit * num // (den * post)
    # smallest sub-batch >= frames/8 that divides frames (bounds the scan
    # working set at ~1/8 of the all-at-once product)
    sub = next(s for s in range(-(-frames // 8), frames + 1)
               if frames % s == 0)
    return SuperstepPlan(out_chunk=unit, frames=frames, sub=sub,
                         wb_chunk=frames * chz.geo.input_size,
                         fs1_chunk=frames * post)


class SuperstepEngine:
    """Holds the carried device state and the jitted super-block program.

    Demod-side state (AGC, tracker, symbol ring, MF tails) lives in the
    ChannelBank exactly as for the unfused paths; this engine adds the
    frontend's carries: the overlap-save wideband tail, the per-channel
    mixer phase, and the previous fs1 block (+taps/2 pre-roll) for the
    one-block-delayed resampler.
    """

    def __init__(self, chz, bank, input_kind: str = 'CS16'):
        plan = plan_superstep(chz)
        if plan is None:
            raise ValueError('geometry does not align for superstep')
        assert bank._sharding is None, 'superstep path is single-device'
        self.chz = chz
        self.bank = bank
        self.plan = plan
        self.input_kind = input_kind.upper()
        if self.input_kind not in ('CS16', 'CU8', 'CF32'):
            raise ValueError(f'unsupported input kind {input_kind}')
        self.rows = chz.rows
        k = chz._rs_taps
        self.pre = k // 2             # fs1 pre-roll before the delayed block
        self._wb_tail = jnp.zeros((chz.geo.overlap_length,), jnp.complex64)
        self._fs1_tail = jnp.zeros((self.rows, self.pre + plan.fs1_chunk),
                                   jnp.complex64)
        self.blocks_done = 0

    # latency between the stream sample clock and the tracker's symbol
    # clock introduced by the one-block resampler delay
    @property
    def delay_symbols(self) -> int:
        return self.plan.symbols

    @property
    def raw_chunk_bytes(self) -> int:
        from ..io import formats
        return self.plan.wb_chunk * formats.bytes_per_sample(self.input_kind)

    # ---- host API ----

    def upload(self, raw: np.ndarray) -> jax.Array:
        """Host raw bytes (exactly raw_chunk_bytes, zero-padded by the
        chunker at stream end) -> the device array the superstep takes.
        Integer formats ride as UNTOUCHED i32 words; conversion to
        complex happens inside the superstep program itself, so there is
        no separate convert dispatch."""
        if self.input_kind == 'CF32':
            return jnp.asarray(np.frombuffer(np.ascontiguousarray(raw),
                                             np.complex64))
        return jnp.asarray(np.ascontiguousarray(raw).view('<i4'))

    def process_packed(self, packed: jax.Array) -> list:
        """One super-block: dispatch the program, hand the (pipelined)
        event readout to the bank's collector."""
        b = self.bank
        (b.agc_state, b.tracker_state, b.symring, b._ringmeta, b._tail,
         b._lvl_tail, self._wb_tail, self._fs1_tail,
         self.chz._mixer_phase, ev_table, counters) = self._step(
            packed, self.chz._idx, self.chz._hwin, self.chz._residual_dev,
            self.chz._bank, b.agc_state, b.tracker_state, b.symring,
            b._ringmeta, b._tail, b._lvl_tail, self._wb_tail,
            self.chz._mixer_phase, self._fs1_tail)
        readout = b._collect_dispatch(ev_table)
        self.blocks_done += 1
        return b._finish_step(readout, counters)

    # ---- device program ----

    def _convert(self, packed: jax.Array) -> jax.Array:
        """Packed upload words -> (wb_chunk,) complex64, matching
        io/formats.convert bit-for-bit (input-helpers.c:94-126)."""
        n = self.plan.wb_chunk
        if self.input_kind == 'CF32':
            return packed
        w = packed.reshape(-1)
        if self.input_kind == 'CS16':
            # little-endian int16 pairs viewed as i32: I = low half,
            # Q = high half (no host-side repacking at all)
            w = w[:n]
            re = jnp.right_shift(jnp.left_shift(w, 16), 16).astype(jnp.float32)
            im = jnp.right_shift(w, 16).astype(jnp.float32)
            scale = np.float32(1.0) / np.float32(32767.5)
            return jax.lax.complex(re * scale, im * scale)
        # CU8: 4 bytes per word = 2 complex samples
        def byte(k):
            return jnp.bitwise_and(
                jax.lax.shift_right_logical(w, 8 * k), 0xFF
            ).astype(jnp.float32)
        re = jnp.stack([byte(0), byte(2)], axis=1).reshape(-1)[:n]
        im = jnp.stack([byte(1), byte(3)], axis=1).reshape(-1)[:n]
        scale = np.float32(127.0)
        off = np.float32(63.5)
        return jax.lax.complex((re - off) / scale, (im - off) / scale)

    def _resample_static(self, buf: jax.Array, bank: jax.Array) -> jax.Array:
        """Static-phase coset resampler over the delayed fs1 buffer.

        buf = [pre-roll | previous block | current block]; output i of the
        block reads the window starting at pre + floor(i*num/den) -
        (taps/2 - 1).  Because out_chunk*num/den is an exact integer, the
        per-output fractional phases repeat with period den: coset j
        (outputs j, j+den, ...) is one fixed-phase FIR over a stride-num
        slice -- all slice starts and tap rows are Python constants."""
        chz = self.chz
        k, num, den = chz._rs_taps, chz._rs_num, chz._rs_den
        n_out = self.plan.out_chunk
        m = n_out // den
        span = (m - 1) * num + 1
        rows = buf.shape[0]
        cosets = []
        for j in range(den):
            tj = j * num
            b_j = tj // den
            frac_j = (tj - b_j * den) / den
            taps_j = bank[int(round(frac_j * 64))]          # (k,) device row
            start0 = self.pre + b_j - (k // 2 - 1)
            acc = jnp.zeros((rows, m), buf.dtype)
            for t in range(k):
                sl = jax.lax.slice(buf, (0, start0 + t),
                                   (rows, start0 + t + span), (1, num))
                acc = acc + sl * taps_j[t]
            cosets.append(acc)
        return jnp.stack(cosets, axis=2).reshape(rows, n_out)

    @functools.partial(jax.jit, static_argnums=(0,),
                       donate_argnums=_DONATE_SS)
    def _step(self, packed, idxtab, hwin, residual, rs_bank,
              agc_state, tracker_state, symring, ringmeta, mtail, ltail,
              wb_tail, mixer_phase, fs1_tail):
        plan = self.plan
        chz = self.chz
        geo = chz.geo
        x = self._convert(packed)
        wb = jnp.concatenate([wb_tail, x])     # (overlap + F*input,)
        new_wb_tail = wb[wb.shape[0] - geo.overlap_length:]
        iters = plan.frames // plan.sub
        subwin = (plan.sub - 1) * geo.input_size + geo.fft_size
        starts = jnp.arange(iters, dtype=jnp.int32) * (plan.sub
                                                       * geo.input_size)

        def body(phase, start):
            win = jax.lax.dynamic_slice(wb, (start,), (subwin,))
            frames = jnp.stack([
                jax.lax.slice(win, (j * geo.input_size,),
                              (j * geo.input_size + geo.fft_size,))
                for j in range(plan.sub)])
            out, phase = chz.ddc_frames(frames, phase, idxtab, hwin,
                                        residual)
            return phase, out

        phase_end, ys = jax.lax.scan(body, mixer_phase, starts)
        fs1 = ys.transpose(1, 0, 2).reshape(self.rows, plan.fs1_chunk)
        buf = jnp.concatenate([fs1_tail, fs1], axis=1)
        y = self._resample_static(buf, rs_bank)
        new_fs1_tail = buf[:, plan.fs1_chunk:]
        (agc_state, tracker_state, symring, ringmeta, mtail, ltail,
         _outs, ev_table, counters) = _channel_step_body(
            agc_state, tracker_state, symring, ringmeta, mtail, ltail, y,
            plan.symbols, False, self.bank.tracker)
        return (agc_state, tracker_state, symring, ringmeta, mtail, ltail,
                new_wb_tail, new_fs1_tail, phase_end, ev_table, counters)
