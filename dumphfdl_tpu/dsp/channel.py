"""Narrowband channel demodulator: 5400 sps complex in -> decoded PDUs out.

Composition of the device-side stages, batched over channels:

  AGC (scan, liquid agc_crcf behavior, hfdl.c:485-487) ->
  matched filter (batched conv, hfdl.c:148-155,694-695) ->
  tracker scan (timing/costas/EQ/framer, tracker.py) ->
  contiguous per-channel symbol ring (the frame sink) ->
  frame backend (event-gather + descramble/deinterleave/Viterbi,
  backend.py)

State is carried across blocks so arbitrarily long streams decode
incrementally; blocks may be up to MAX_BLOCK_SYMBOLS (3 s) so the
symbol ring always holds every completed frame until it is collected.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import platform
from ..ops import crc
from . import backend
from .tracker import (EV_FIELDS, HALO, K_EVENTS, TrackerOutputs,
                      TrackerState, tracker_block_auto, tracker_init)


class AgcState(NamedTuple):
    gain: jax.Array      # (C,) f32
    energy: jax.Array    # (C,) f32 smoothed output energy


def agc_init(num_channels: int) -> AgcState:
    return AgcState(gain=jnp.ones((num_channels,), jnp.float32),
                    energy=jnp.ones((num_channels,), jnp.float32))


@jax.jit
def agc_block(state: AgcState, x: jax.Array) -> tuple[AgcState, jax.Array, jax.Array]:
    """AGC: normalize each channel to unit RMS with bandwidth 0.01.

    Parallel reformulation of liquid agc_crcf (hfdl.c:485-487): instead of
    the serial log-gain feedback on *output* energy, track an EMA of
    *input* energy and set g = 1/sqrt(e).  Same equilibrium (unit output
    energy) and the same single-pole bandwidth, but monotone convergence
    (no transient limit cycles) -- and the EMA is an associative scan, so
    XLA can parallelize it.

    Returns (state, y (C,T) normalized, level (C,T) input-level estimate
    == agc_crcf_get_signal_level).
    """
    a = C.AGC_BANDWIDTH
    # associative first-order recurrence: e_t = (1-a) e_{t-1} + a p_t
    p = a * (x.real ** 2 + x.imag ** 2)           # (C, T)
    decay = jnp.full_like(p, 1.0 - a)

    def combine(c1, c2):
        d1, s1 = c1
        d2, s2 = c2
        return d1 * d2, s1 * d2 + s2

    d, s = jax.lax.associative_scan(combine, (decay.T, p.T), axis=0)
    e = d * state.energy[None, :] + s             # (T, C)
    e = e.T
    level = jnp.sqrt(jnp.maximum(e, 1e-12))
    g = jnp.clip(1.0 / level, 1e-6, 1e6)
    new_state = AgcState(gain=g[:, -1], energy=e[:, -1])
    return new_state, x * g, level


@jax.jit
def matched_filter(x: jax.Array) -> jax.Array:
    """19-tap matched FIR, causal, batched over channels (hfdl.c:694-695)."""
    taps = jnp.asarray(np.asarray(C.MF_TAPS, np.float32))
    k = taps.shape[0]
    xp = jnp.pad(x, ((0, 0), (k - 1, 0)))

    def conv1(row):
        # full f32: a TF32 convolution would round the samples to 10 bits
        return jnp.convolve(row, taps, mode='valid',
                            precision=jax.lax.Precision.HIGHEST)

    re = jax.vmap(conv1)(xp.real)
    im = jax.vmap(conv1)(xp.imag)
    return (re + 1j * im).astype(jnp.complex64)


class FrameEvent(NamedTuple):
    """Host-side record of one completed frame."""
    channel: int
    mode: int
    bitmask: bool
    freq_err_hz: float
    rssi: float           # linear signal level
    noise_floor: float    # linear
    train_bad: int
    train_total: int
    start_symbol: int     # absolute symbol index of frame start (prekey)
    pdu: bytes | None = None
    # header-FCS verdict (device _device_fcs_ok / host crc.pdu_fcs_ok):
    # False = junk (noise false-lock or uncorrected errors); the app
    # still parses it (for --output-corrupted-pdus parity) but accounts
    # it separately (pdu.c:66-79)
    fcs_ok: bool = False


# ---- per-channel symbol ring (the frame sink) ---------------------------
#
# Every equalized symbol is appended CONTIGUOUSLY to a per-channel ring
# (one dynamic_update_slice per block); completed frames are extracted at
# event time by gathering their data symbols via the rigid post-A2 frame
# schedule (backend.gather_event_symbols).  Scattering each data symbol
# into rotating per-frame buffers instead would be a (T*C)-element
# arbitrary scatter per block; the contiguous append is one copy and the
# per-event gather only runs for actual events.
#
# Instead of modular wraparound (which would need scatter again), the
# ring is compacted: when the write cursor would pass RING_T, the last
# RING_KEEP symbols slide to the front (two fast contiguous copies) and
# the base row advances.  RING_KEEP covers the deepest lookback: a
# double-slot frame whose event is collected up to two blocks late.

RING_T = 32768
MAX_BLOCK_SYMBOLS = 5400            # 16200 samples (3 s) per demod block
RING_KEEP = C.DOUBLE_SLOT_FRAME_LEN + 2 * MAX_BLOCK_SYMBOLS + 64

_GATHER_BATCH_MIN = 32      # smallest padded gather batch
_GATHER_BATCH_MAX = 2048    # largest single dispatch


def _ring_update(symring: jax.Array, ringmeta: jax.Array, sym_tc: jax.Array):
    """Append one block of symbols ((C, T) channel-major) at the device
    write cursor; ringmeta = [[wcur], [base22]] i32.  When the block
    would pass the ring end, the kept history slides to the front first.
    The slide is BRANCH-FREE (shift=0 copies the prefix onto itself), so
    one compiled variant serves every block -- a conditional variant
    would compile mid-stream at the first compaction and stall the live
    loop."""
    c = symring.shape[0]
    t = sym_tc.shape[1]
    wcur = ringmeta[0, 0]
    base22 = ringmeta[1, 0]
    do_c = wcur + t > RING_T
    shift = jnp.where(do_c, wcur - RING_KEEP, 0)
    tail = jax.lax.dynamic_slice(symring, (jnp.int32(0), shift),
                                 (c, RING_KEEP))
    symring = jax.lax.dynamic_update_slice(symring, tail,
                                           (jnp.int32(0), jnp.int32(0)))
    base22 = (base22 + shift) & ((1 << 22) - 1)
    wcur = jnp.where(do_c, RING_KEEP, wcur)
    symring = jax.lax.dynamic_update_slice(symring, sym_tc,
                                           (jnp.int32(0), wcur))
    meta = jnp.stack([(wcur + t)[None], base22[None]])
    return symring, meta


@functools.partial(jax.jit, static_argnames=('mode',))
def _gather_decode(symring: jax.Array, base22: jax.Array, ch: jax.Array,
                   start22: jax.Array, bitmask: jax.Array,
                   mode: int) -> jax.Array:
    """Gather + decode selected frames of one mode entirely on device:
    the gather event path reads back only the decoded BITS, never the
    frame symbols."""
    nsym = C.MODES[mode].num_data_symbols
    sel = backend.gather_event_symbols(symring, start22[:, 0],
                                       base22[0, 0], ch[:, 0])[:, :nsym]
    return backend._decode_core(sel, bitmask[:, 0], mode)


def _channel_step_body(agc_state, tracker_state, symring, ringmeta, tail,
                       lvl_tail, x, num_steps, debug_taps, tracker,
                       mesh=None, mesh_axes=('chan',)):
    """Shared trace of the fused demod step (see channel_step); tracker
    names the tracker implementation and mesh/mesh_axes the channel
    sharding it runs under (tracker.tracker_block_auto)."""
    agc_state, y, level = agc_block(agc_state, x)
    mf = matched_filter(y)
    mf_ext = jnp.concatenate([tail, mf], axis=1)
    lvl_ext = jnp.concatenate([lvl_tail, level], axis=1)
    new_tail = mf_ext[:, -HALO:]
    new_lvl_tail = lvl_ext[:, -HALO:]
    tracker_state, outs, ev_table, counters = tracker_block_auto(
        tracker_state, mf_ext, lvl_ext, num_steps, debug_taps, tracker,
        mesh, mesh_axes)
    symring, ringmeta = _ring_update(symring, ringmeta, outs.sym.T)
    return (agc_state, tracker_state, symring, ringmeta, new_tail,
            new_lvl_tail, outs, ev_table, counters)


@functools.partial(jax.jit, static_argnames=('e_max',))
def fused_collect(symring: jax.Array, ringmeta: jax.Array,
                  ev_table: jax.Array, e_max: int) -> jax.Array:
    """On-device event decode as its own program: event table + packed
    decoded bits of up to e_max frames in ONE int32 readout buffer.

    The buffer is INT32, with the f32 event table bitcast into it -- not
    the decoded words bitcast to f32 -- because a packed word whose bits
    form an f32 denormal may be flushed to zero by f32 arithmetic or
    copies (even the FCS verdict word 0x00000001 is a denormal).
    Integer lanes have no denormal semantics; the table's f32 values are
    reinterpreted, moved as ints, and bitcast back on the host.

    The all-modes decode rides a real XLA conditional gated on the
    block having ANY events: idle channels dominate production blocks,
    and the decoder's 8-mode batch is the expensive part of this
    program (the reference's analogue: the PDU decoder thread sleeps
    until a frame arrives, pdu.c:91)."""
    c = symring.shape[0]
    tab = ev_table.reshape(c, K_EVENTS * EV_FIELDS)
    any_events = jnp.any(
        tab.reshape(c, K_EVENTS, EV_FIELDS)[:, :, 0] > 0.5)

    def decode(_):
        return backend.decode_events_inline(symring, ringmeta[1, 0],
                                            ev_table, e_max)

    def empty(_):
        out = jnp.zeros((e_max, 2 + backend.PACK_WORDS), jnp.int32)
        return out.at[:, 0].set(-1)

    decoded = jax.lax.cond(any_events, decode, empty, operand=None)
    return jnp.concatenate([
        jax.lax.bitcast_convert_type(ev_table.reshape(-1), jnp.int32),
        decoded.reshape(-1),
    ])


def _resample_ring(fs1_ring, bank, rs_state, rs_const):
    """Polyphase resample of one out-chunk straight from the channelizer's
    fs1 ring, positions from the device-carried exact integer cursor.

    With the exact rational ratio num/den, output i and output i+den read
    the ring exactly `num` samples apart with the SAME fractional phase,
    so the chunk decomposes into `den` cosets, each a fixed-phase FIR over
    a stride-`num` slice of one contiguous slab.  That turns the
    (C, n_out, K) arbitrary gather into den*K strided slices + FMAs."""
    k, num, den, n_out = rs_const
    m = n_out // den                     # outputs per coset
    c = fs1_ring.shape[0]
    r1 = fs1_ring.shape[1]
    a_fnum = rs_state[0, 0]
    a_int = rs_state[1, 0]
    rstart = rs_state[2, 0]
    # one contiguous (modular) slab covers every window of the chunk
    slab_len = m * num + k + 2
    start = jnp.mod(rstart + a_int - (k // 2 - 1), r1)
    ring2 = jnp.concatenate([fs1_ring, fs1_ring[:, :slab_len]], axis=1)
    slab = jax.lax.dynamic_slice(ring2, (jnp.int32(0), start), (c, slab_len))
    span = (m - 1) * num + 1
    cosets = []
    for j in range(den):
        tj = a_fnum + j * num
        b_j = tj // den
        frac_j = (tj - b_j * den).astype(jnp.float32) / jnp.float32(den)
        taps_j = bank[jnp.round(frac_j * 64).astype(jnp.int32)]   # (K,)
        acc = jnp.zeros((c, m), slab.dtype)
        for t in range(k):
            sl = jax.lax.dynamic_slice(
                slab, (jnp.int32(0), b_j + t), (c, span))[:, ::num]
            acc = acc + sl * taps_j[t]
        cosets.append(acc)
    # interleave cosets: output i = coset (i % den) sample (i // den)
    return jnp.stack(cosets, axis=2).reshape(c, n_out)


def _rs_advance(rs_state, rs_const, ring_len):
    """Advance the resampler cursor past one out-chunk and free consumed
    ring space (mirrored bit-for-bit by Channelizer.consume_chunk)."""
    k, num, den, n_out = rs_const
    a_num = rs_state[0, 0] + rs_state[1, 0] * den + n_out * num
    a_int = a_num // den
    a_fnum = a_num - a_int * den
    drop = jnp.maximum(a_int - k, 0)
    rstart = (rs_state[2, 0] + drop) % ring_len
    return jnp.stack([a_fnum[None], (a_int - drop)[None], rstart[None]])


@functools.partial(jax.jit,
                   static_argnames=('num_steps', 'rs_const', 'debug_taps',
                                    'tracker'),
                   donate_argnums=(0, 1, 2, 3, 4, 5, 7))
def channel_step_fused(agc_state: AgcState,
                       tracker_state: TrackerState,
                       symring: jax.Array,
                       ringmeta: jax.Array,
                       tail: jax.Array,
                       lvl_tail: jax.Array,
                       fs1_ring: jax.Array,
                       rs_state: jax.Array,
                       rs_bank: jax.Array,
                       num_steps: int,
                       rs_const: tuple,
                       debug_taps: bool = False,
                       tracker: str = 'scan'):
    """channel_step with the channelizer->5400 sps resampler folded in:
    the steady-state demod loop is ONE dispatch + one readback per block
    (no separate resample dispatch or parameter upload).

    fs1_ring is read-only (the channelizer appends to it in its own
    fused program); rs_state is the device-carried exact-rational
    cursor, advanced here and mirrored on host by
    Channelizer.consume_chunk."""
    x = _resample_ring(fs1_ring, rs_bank, rs_state, rs_const)
    out = _channel_step_body(agc_state, tracker_state, symring, ringmeta,
                             tail, lvl_tail, x, num_steps, debug_taps,
                             tracker)
    new_rs = _rs_advance(rs_state, rs_const, fs1_ring.shape[1])
    return out + (new_rs,)


@functools.partial(jax.jit,
                   static_argnames=('num_steps', 'debug_taps', 'tracker',
                                    'mesh', 'mesh_axes'),
                   donate_argnums=(0, 1, 2, 3, 4, 5))
def channel_step(agc_state: AgcState,
                 tracker_state: TrackerState,
                 symring: jax.Array,
                 ringmeta: jax.Array,
                 tail: jax.Array,
                 lvl_tail: jax.Array,
                 x: jax.Array,
                 num_steps: int,
                 debug_taps: bool = False,
                 tracker: str = 'scan',
                 mesh=None,
                 mesh_axes: tuple = ('chan',)):
    """One fused device step: AGC -> MF -> tracker -> ring append.

    This is the flagship forward step: everything from normalized samples
    to labeled symbols and filled frame buffers in a single XLA program,
    with all sequential state donated and carried across calls.  Event
    decode runs as a separate small program (fused_collect) -- see the
    note there on why it must not be fused in.
    """
    return _channel_step_body(agc_state, tracker_state, symring, ringmeta,
                              tail, lvl_tail, x, num_steps, debug_taps,
                              tracker, mesh, mesh_axes)


@dataclasses.dataclass
class ChannelBank:
    """Streaming demodulator for a batch of channels at 5400 sps.

    When more than one local device is visible (or an explicit mesh is
    passed), the channel axis is sharded over them: channels are
    embarrassingly parallel (SURVEY.md §2.9 -- the reference's
    one-FFT-to-N-threads broadcast becomes a sharded batch axis), so the
    fused demod step runs with zero collectives; only the event-table
    readback gathers."""
    num_channels: int
    mesh: object = None            # jax.sharding.Mesh with a 'chan' axis
    mesh_axes: tuple = ('chan',)   # mesh axes the channel dim shards over
    auto_shard: bool = True        # shard over local devices when >1
    # pipeline_events=True defers event collection by ONE block: process()
    # returns the PREVIOUS block's events, so the event-table readback and
    # backend decode of block N-1 overlap block N's device compute instead
    # of serializing after it (the readback is the only sync point in the
    # streaming loop).  Callers must then drain_events() at end of stream.
    # Safe while blocks are shorter than one frame (enforced below): the
    # deferred gather reads a (parity) frame buffer that cannot be
    # rewritten for >= 2 frame lengths.
    pipeline_events: bool = False
    # fused_event_decode: max frames decoded per block by the separate
    # on-device event-decode program (one-readout collection); 0 = the
    # per-mode gather+decode path.  tracker: the tracker implementation
    # (tracker.tracker_block_auto).  None = the platform's choice
    # (platform.py).
    fused_event_decode: int | None = None
    tracker: str | None = None
    agc_state: AgcState = None
    tracker_state: TrackerState = None
    symring: jax.Array = None      # (C, RING_T) contiguous symbol history
    _ringmeta: jax.Array = None    # (2, 1) i32 [wcur, base22], device-carried
    _tail: jax.Array = None        # (C, HALO) input halo (post-MF domain inputs)
    _lvl_tail: jax.Array = None

    dumps: object = None        # optional dumpfile.DumpSet for --datadumps

    def __post_init__(self):
        choice = platform.current()
        if self.fused_event_decode is None:
            self.fused_event_decode = choice.fused_event_decode
        if self.tracker is None:
            self.tracker = choice.tracker
        if self.tracker not in platform.TRACKERS:
            raise ValueError(f'unknown tracker {self.tracker!r}')
        if self.mesh is None and self.auto_shard \
                and not os.environ.get('DUMPHFDL_NO_AUTOSHARD') \
                and len(jax.local_devices()) > 1:
            from jax.sharding import Mesh
            self.mesh = Mesh(np.asarray(jax.local_devices()), ('chan',))
        ndev = 1
        self._sharding = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            ndev = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names
                                if a in self.mesh_axes])) or 1
            self._sharding = NamedSharding(
                self.mesh, PartitionSpec(tuple(self.mesh_axes)))
        # pad the channel axis to a multiple of the device count
        self._c = -(-self.num_channels // ndev) * ndev
        c = self._c
        self.agc_state = agc_init(c)
        self.tracker_state = tracker_init(c)
        self.symring = jnp.zeros((c, RING_T), jnp.complex64)
        self._ringmeta = jnp.zeros((2, 1), jnp.int32)
        self._tail = jnp.zeros((c, HALO), jnp.complex64)
        self._lvl_tail = jnp.ones((c, HALO), dtype=jnp.float32)
        if self._sharding is not None:
            from ..parallel.sharding import place_global
            place = lambda t: place_global(t, self._sharding)
            self.agc_state = jax.tree.map(place, self.agc_state)
            self.tracker_state = jax.tree.map(place, self.tracker_state)
            self.symring = place(self.symring)
            self._tail = place(self._tail)
            self._lvl_tail = place(self._lvl_tail)

    def _check_block_invariant(self, num_steps: int) -> None:
        # the symbol ring keeps RING_KEEP rows of history across
        # compactions; an event's data (up to a double-slot frame back)
        # must still be resident when it is decoded, up to 2 blocks
        # after completion when event collection is pipelined
        if num_steps > MAX_BLOCK_SYMBOLS:
            raise ValueError(
                f'block of {num_steps * C.SPS} samples ({num_steps} '
                f'symbols) exceeds the symbol-ring history invariant '
                f'(max {MAX_BLOCK_SYMBOLS} symbols = '
                f'{MAX_BLOCK_SYMBOLS * C.SPS} samples); split the '
                f'stream into smaller blocks')

    def process(self, samples: np.ndarray) -> list[FrameEvent]:
        """Feed a (C, T) block at 5400 sps; returns completed frames."""
        if isinstance(samples, jax.Array):
            x = samples       # already device-resident (shape (C_pad, T))
        else:
            samples = np.asarray(samples, dtype=np.complex64)
            if samples.shape[0] != self._c:       # pad dummy channels
                pad = np.zeros((self._c - samples.shape[0],
                                samples.shape[1]), np.complex64)
                samples = np.concatenate([samples, pad], axis=0)
            if self._sharding is not None:
                from ..parallel.sharding import place_global
                x = place_global(samples, self._sharding)
            else:
                x = jnp.asarray(samples)
        num_steps = int(x.shape[1] // C.SPS)   # x is the raw block; the
        # carried HALO tail is prepended inside channel_step
        self._check_block_invariant(num_steps)
        if self.dumps is not None:       # --datadumps debug taps
            self.dumps.write('chan_out', np.asarray(x))
            _, y_dbg, lvl_dbg = agc_block(self.agc_state, x)
            self.dumps.write('agc_out', np.asarray(y_dbg))
            self.dumps.write('agc_level', np.asarray(lvl_dbg))
            self.dumps.write('mf_out', np.asarray(matched_filter(y_dbg)))
        (self.agc_state, self.tracker_state, self.symring, self._ringmeta,
         self._tail, self._lvl_tail, outs, ev_table, counters) = channel_step(
            self.agc_state, self.tracker_state, self.symring,
            self._ringmeta, self._tail, self._lvl_tail, x, num_steps,
            self.dumps is not None, self.tracker, self.mesh,
            tuple(self.mesh_axes))
        readout = self._collect_dispatch(ev_table)
        if self.dumps is not None:
            sym = np.asarray(outs.sym).T          # (C, T_out)
            self.dumps.write('sym_out', sym)
            isd = np.asarray(outs.is_data).T
            self.dumps.write('const', np.where(isd, sym, np.nan + 0j))
            taps = np.asarray(outs.taps)          # (T_out, C, 3)
            self.dumps.write('costas_dphi', taps[:, :, 0].T)
            self.dumps.write('costas_err', taps[:, :, 1].T)
            self.dumps.write('symsync_tau', taps[:, :, 2].T)
        return self._finish_step(readout, counters)

    def process_fused(self, chan) -> list[FrameEvent]:
        """Consume one out_chunk straight from a Channelizer's fs1 ring:
        resample + AGC + MF + tracker + symbol ring in ONE dispatch
        (channel_step_fused), with the resampler cursor carried on
        device.  The streaming path when the superstep does not apply."""
        num_steps = chan.out_chunk // C.SPS
        self._check_block_invariant(num_steps)
        rs_const = (chan._rs_taps, chan._rs_num, chan._rs_den,
                    chan.out_chunk)
        (self.agc_state, self.tracker_state, self.symring, self._ringmeta,
         self._tail, self._lvl_tail, outs, ev_table, counters,
         new_rs) = channel_step_fused(
            self.agc_state, self.tracker_state, self.symring,
            self._ringmeta, self._tail, self._lvl_tail, chan._fs1_ring,
            chan.rs_device_state(), chan._bank, num_steps, rs_const, False,
            self.tracker)
        readout = self._collect_dispatch(ev_table)
        chan.consume_chunk(new_rs)
        return self._finish_step(readout, counters)

    def _finish_step(self, ev_table, counters) -> list[FrameEvent]:
        self.last_counters = counters    # (C, 4): A2, M1, M1-miss, event-overflow deltas
        self._last_ev_table = ev_table    # kept for soak/replay tooling
        if not self.pipeline_events:
            return self._collect_events(ev_table)
        prev = getattr(self, '_pending_ev', None)
        self._pending_ev = ev_table
        return self._collect_events(prev) if prev is not None else []

    def drain_events(self) -> list[FrameEvent]:
        """Collect the deferred block's events (pipeline_events mode)."""
        prev = getattr(self, '_pending_ev', None)
        self._pending_ev = None
        return self._collect_events(prev) if prev is not None else []

    def _collect_dispatch(self, ev_table):
        """Dispatch the standalone event-decode program (fused_collect)
        for this block's table; plain table readout when the on-device
        decode is off (gather path)."""
        if not self.fused_event_decode:
            return ev_table
        return fused_collect(self.symring, self._ringmeta, ev_table,
                             self.fused_event_decode)

    def _collect_events(self, readout) -> list[FrameEvent]:
        """Decode completed frames from the per-block readout.

        Fused path: `readout` is ONE flat int32 buffer -- the bitcast
        event table followed by on-device-decoded frame bits
        (channel.fused_collect) -- so collection costs exactly one
        transfer.  Plain path:
        `readout` is the (C, K*F) f32 event table; frame symbols are
        fetched with one padded on-device gather and decoded in
        per-mode batches (bounded compiled shapes).  Overflow past the
        fused capacity falls back to the gather path for the excess
        events."""
        flatlen = self._c * K_EVENTS * EV_FIELDS
        from ..parallel.sharding import fetch_global
        buf = fetch_global(readout)
        dec = None
        if buf.ndim == 1 and buf.size > flatlen:
            buf = np.ascontiguousarray(buf.astype(np.int32, copy=False))
            table = buf[:flatlen].view(np.float32) \
                .reshape(self._c, K_EVENTS, EV_FIELDS)
            dec = buf[flatlen:].reshape(-1, 2 + backend.PACK_WORDS)
        else:
            table = buf.reshape(self._c, K_EVENTS, EV_FIELDS)
        valid = table[:, :, 0] > 0.5
        valid[self.num_channels:] = False      # padded dummy channels
        if not valid.any():
            return []
        chans, slots = np.nonzero(valid)
        flat_rows = chans * K_EVENTS + slots   # ascending, = device order
        f = table[chans, slots]                # (n, EV_FIELDS), vectorized
        n_ev = len(chans)
        modes = f[:, 1].astype(np.int64)
        bitmasks = f[:, 2] > 0.5
        start22s = f[:, 10].astype(np.int32)
        events = [FrameEvent(
            channel=int(chans[i]), mode=int(modes[i]),
            bitmask=bool(bitmasks[i]),
            freq_err_hz=float(f[i, 4]),
            rssi=float(f[i, 5]),
            noise_floor=float(f[i, 6]),
            train_bad=int(f[i, 7]),
            train_total=int(f[i, 8]),
            start_symbol=int(f[i, 9]),
        ) for i in range(n_ev)]
        need_gather = list(range(n_ev))
        if dec is not None:
            # match by row id, not position: decode_events_inline scans
            # ALL table rows (including padded dummy channels), so a
            # spurious event on a padded row must not shift the mapping
            by_row = {int(r): j for j, r in enumerate(dec[:, 0]) if r >= 0}
            need_gather = []
            for i in range(n_ev):
                j = by_row.get(int(flat_rows[i]))
                if j is not None:
                    fb = C.MODES[events[i].mode].framebits
                    words = dec[j, 2:].astype(np.uint32)
                    bits = ((words[:, None]
                             >> np.arange(32, dtype=np.uint32)[None, :]) & 1
                            ).astype(np.uint8).reshape(-1)[:fb]
                    events[i] = events[i]._replace(
                        pdu=backend.pdu_bytes_from_bits(bits[None])[0],
                        fcs_ok=bool(dec[j, 1]))
                else:                       # fused-capacity overflow
                    need_gather.append(i)
        if need_gather:
            events = self._decode_by_gather(events, np.asarray(need_gather),
                                            chans, start22s, modes, bitmasks)
        return events

    def _decode_by_gather(self, events, idxs, chans, start22s, modes,
                          bitmasks) -> list[FrameEvent]:
        """On-device gather+decode path for the given event indices,
        batched per mode (<= 8 modes x log2(batch) compiled shapes);
        only decoded bits cross back to the host."""
        sub_modes = modes[idxs]
        for mode in np.unique(sub_modes):
            rel = np.nonzero(sub_modes == mode)[0]
            fb = C.MODES[mode].framebits
            for off in range(0, len(rel), _GATHER_BATCH_MAX):
                n = min(_GATHER_BATCH_MAX, len(rel) - off)
                sel = idxs[rel[off:off + n]]
                batch = max(_GATHER_BATCH_MIN,
                            1 << int(np.ceil(np.log2(n))))
                ch_pad = np.zeros((batch, 1), np.int32)
                st_pad = np.zeros((batch, 1), np.int32)
                bm_pad = np.zeros((batch, 1), np.int32)
                ch_pad[:n, 0] = chans[sel]
                st_pad[:n, 0] = start22s[sel]
                bm_pad[:n, 0] = bitmasks[sel]
                # cross-process arrays: plain numpy args are treated as
                # replicated by the multiprocess jit; committed
                # single-device puts would conflict with the global mesh
                multi = isinstance(self.symring, jax.Array) \
                    and not self.symring.is_fully_addressable
                put = (lambda a: a) if multi else jnp.asarray
                from ..parallel.sharding import fetch_global as _fg
                bits = _fg(_gather_decode(
                    self.symring, self._ringmeta[1:2], put(ch_pad),
                    put(st_pad), put(bm_pad),
                    int(mode)))[:n, :fb]
                pdus = backend.pdu_bytes_from_bits(bits)
                for r, pdu in zip(sel, pdus):
                    events[r] = events[r]._replace(
                        pdu=pdu, fcs_ok=crc.pdu_fcs_ok(pdu))
        return events
