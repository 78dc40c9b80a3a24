"""Wideband FFT channelizer: one capture -> N channel streams at 5400 sps.

Batched re-architecture of the reference's fastddc overlap-&-scrap DDC
(/root/reference/src/fastddc.c, src/fft.c):

* The forward overlap-save FFT is *batched over blocks* (strided framing +
  one batched FFT) instead of one serial FFT thread.
* Per-channel work is a **bin-window gather**: the complex bandpass
  filter's FFT is significant only within a few images of the channel's
  passband (measured < -80 dB outside +-2 images), so instead of
  materializing the full (blocks, channels, fft_size) product and rolling
  it per channel (the reference's multiply_and_shift walks all fft_size
  bins per channel, fastddc.c:123-150), each channel gathers its W =
  window_images * fft_inv_size relevant bins, multiplies by the
  pre-shifted kernel window, folds the images, and runs one *batched*
  inverse FFT of fft_inv_size.  At 128 channels x 262144-point FFT this
  is ~64x less HBM traffic than the full product.
* All streaming buffers are device-resident **modular rings** addressed
  by host-tracked integer cursors: appends are modular scatters and
  reads are modular gathers, so nothing is ever memmoved/rolled (the
  reference's overlap memmove, fft.c:49-54, becomes index arithmetic).
* The reference's separate residual-shift rotator + time decimator +
  arbitrary resampler (libcsdr_gpl.c:41-74, msresamp at hfdl.c:471-473)
  collapse into one mixer + polyphase arbitrary resampler straight from
  fs/pre_decimation to 5400 sps.

Geometry formulas replicate fastddc_init (fastddc.c:46-80) so filter
lengths/overlap match the reference's numerical design.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C


def next_pow2(x: int) -> int:
    """Smallest power of two strictly greater than x (libcsdr.c:36-45)."""
    p = 1
    while p <= x:
        p *= 2
    return p


def compute_fft_decimation_rate(sample_rate: int, target_rate: int = C.INTERNAL_RATE) -> int:
    """libcsdr.c:140-144 / main.c:699."""
    return next_pow2(int(sample_rate // target_rate)) // 2


def firdes_filter_len(transition_bw: float) -> int:
    n = int(4.0 / transition_bw)
    return n + 1 if n % 2 == 0 else n


def firdes_lowpass(length: int, cutoff_rate: float) -> np.ndarray:
    """Windowed-sinc lowpass, Hamming window (libcsdr.c:94-108)."""
    middle = length // 2
    i = np.arange(1, middle + 1)
    rate = 0.5 + (i / middle) / 2
    win = 0.54 - 0.46 * np.cos(2 * np.pi * rate)
    taps = np.empty(length, dtype=np.float64)
    taps[middle] = 2 * np.pi * cutoff_rate   # window_function(0) == 1.0
    side = np.sin(2 * np.pi * cutoff_rate * i) / i * win
    taps[middle + 1:] = side
    taps[middle - 1::-1] = side
    return (taps / taps.sum()).astype(np.float64)


def firdes_bandpass_c(length: int, lowcut: float, highcut: float) -> np.ndarray:
    """Complex bandpass: lowpass spectrally shifted (libcsdr.c:110-133)."""
    real = firdes_lowpass(length, (highcut - lowcut) / 2)
    center = (highcut + lowcut) / 2
    phase = 2 * np.pi * center * np.arange(length)
    return (real * np.exp(1j * phase)).astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class DdcGeometry:
    """Overlap-&-scrap geometry (fastddc.c:46-80 with post folded in-band)."""
    decimation: int         # power of two (compute_fft_decimation_rate)
    taps_length: int
    fft_size: int
    overlap_length: int
    input_size: int
    fft_inv_size: int       # fft_size // decimation
    scrap: int
    post_input_size: int
    v: int                  # coarse-shift bin quantum = fft_size // overlap

    @property
    def fs1_ratio(self) -> int:
        return self.decimation


def compute_geometry(decimation: int, transition_bw: float) -> DdcGeometry:
    taps_min = firdes_filter_len(transition_bw)
    taps_length = next_pow2(-(-taps_min // decimation) * decimation) + 1
    fft_size = next_pow2(taps_length * 4)
    while fft_size < decimation:
        fft_size *= 2
    overlap = taps_length - 1
    input_size = fft_size - overlap
    fft_inv = fft_size // decimation
    v = fft_size // overlap
    scrap = overlap // decimation
    return DdcGeometry(
        decimation=decimation, taps_length=taps_length, fft_size=fft_size,
        overlap_length=overlap, input_size=input_size, fft_inv_size=fft_inv,
        scrap=scrap, post_input_size=fft_inv - scrap, v=v)


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Per-channel downconversion parameters."""
    frequency: int          # Hz (channel frequency, SSB carrier at +1440)
    shift_rate: float       # (centerfreq - (freq+1440)) / fs  (hfdl.c:476)
    coarse_bins: int        # quantized shift, multiple of geometry.v
    residual_cycles: float  # residual shift, cycles per fs1 sample


def plan_channel(geo: DdcGeometry, sample_rate: int, centerfreq: int,
                 frequency: int) -> ChannelPlan:
    shift = (centerfreq - (frequency + C.SSB_CARRIER_OFFSET_HZ)) / sample_rate
    n = geo.fft_size
    b_f = -shift * n
    b = geo.v * int(round(b_f / geo.v))
    # after the coarse shift by b bins the signal sits at (b_f - b) bins;
    # the mixer multiplies by exp(-j*2*pi*residual*n) to remove it
    db = b_f - b
    residual = db * geo.decimation / n   # cycles per fs1 sample
    return ChannelPlan(frequency=frequency, shift_rate=shift,
                       coarse_bins=b, residual_cycles=residual)


@functools.cache
def _resampler_bank(ratio_x1000: int, ntaps: int, nphases: int = 64) -> np.ndarray:
    """Polyphase windowed-sinc bank for arbitrary-rate conversion.

    Bank p interpolates at delay (ntaps//2-1) + p/nphases, with cutoff
    scaled for anti-aliasing when downsampling (60 dB stopband kaiser,
    matching the reference msresamp design intent, hfdl.c:472).
    """
    ratio = ratio_x1000 / 1000.0      # fs_in / fs_out
    cutoff = 0.45 * min(1.0, 1.0 / ratio)
    n = np.arange(ntaps)
    center = ntaps // 2 - 1
    bank = np.zeros((nphases + 1, ntaps), dtype=np.float32)
    win = np.kaiser(ntaps, 7.0)
    for p in range(nphases + 1):
        t = n - (center + p / nphases)
        h = 2 * cutoff * np.sinc(2 * cutoff * t) * win
        bank[p] = h / max(h.sum(), 1e-9)
    return bank


def select_window_images(kernels_fft: np.ndarray, coarse: np.ndarray,
                         geo: DdcGeometry, threshold: float = 1e-4) -> int:
    """Smallest even image count w such that every channel's kernel FFT is
    below `threshold` x peak outside the centered w-image bin window.

    The fold over decimation images (fastddc.c DIF decimation) is exact
    when w == decimation; the Hamming-windowed bandpass concentrates its
    response so tightly that w=4 is < -80 dB exact in practice (measured),
    which is below CS16 input quantization."""
    n, d, L = geo.fft_size, geo.decimation, geo.fft_inv_size
    peak = float(np.abs(kernels_fft).max()) or 1.0
    # vectorized over channels (the per-channel np.delete loop took
    # minutes at 2048 channels x 512k-point FFTs): a window w is big
    # enough when every above-threshold bin lies inside it, i.e. the
    # per-channel count of over-threshold bins inside the window equals
    # the channel's total count
    over = np.abs(kernels_fft) > threshold * peak          # (C, N) bool
    tot = over.sum(axis=1)
    rows = np.arange(kernels_fft.shape[0])[:, None]
    coarse = np.asarray(coarse)[:kernels_fft.shape[0]]
    for w in range(2, d, 2):
        idx = (coarse[:, None].astype(np.int64) - (w // 2) * L
               + np.arange(w * L)[None, :]) % n
        inside = over[rows, idx].sum(axis=1)
        if np.array_equal(inside, tot):
            return w
    return d


class Channelizer:
    """Streaming wideband -> per-channel 5400 sps converter.

    Host-side orchestration with jitted device kernels; all shapes static
    per chunk size.  Sequential state: device-resident wideband ring (with
    the overlap-save tail carried in place), per-channel mixer phase,
    device-resident fs1 ring + resampler position.  The host tracks ring
    cursors as plain integers (never read back); every jitted step does a
    fixed amount of work so the compiled-shape set stays bounded
    (power-of-two frame batches).
    """

    def __init__(self, sample_rate: int, centerfreq: int,
                 frequencies: list[int],
                 decimation: int | None = None,
                 transition_bw: float | None = None,
                 out_chunk: int = 5400,
                 rows: int | None = None,
                 window_images: int | None = None):
        self.fs = int(sample_rate)
        self.centerfreq = int(centerfreq)
        if decimation is None:
            decimation = compute_fft_decimation_rate(self.fs)
        if transition_bw is None:
            transition_bw = C.CHANNEL_TRANSITION_BW_HZ / self.fs
        self.geo = compute_geometry(decimation, transition_bw)
        self.fs1 = self.fs / decimation
        self.plans = [plan_channel(self.geo, self.fs, centerfreq, f)
                      for f in frequencies]
        self.num_channels = len(frequencies)
        # rows >= num_channels: extra zero-kernel rows so downstream
        # consumers with padded channel batches never re-pad on device
        self.rows = self.num_channels if rows is None else int(rows)
        assert self.rows >= self.num_channels
        self.out_chunk = out_chunk

        geo = self.geo
        # Filter kernels: FFT of complex bandpass taps, zero-padded (DC
        # order).  Every channel shares the same lowpass prototype (same
        # bandwidth); only the spectral shift differs, so the bandpass
        # build is one outer product instead of a per-channel firdes
        # loop, and everything runs in ROW CHUNKS of float32: the
        # full (rows, fft_size) complex matrix is never materialized
        # (at 2048 channels x 1M-point FFTs it is 17 GB and swapped the
        # whole process for minutes, also degrading the streaming loop
        # afterwards; chunked init is seconds and keeps nothing but the
        # (rows, W) window tables).
        hbw = 0.5 / decimation
        proto = firdes_lowpass(geo.taps_length, hbw)             # shared
        centers = -np.asarray(
            [p.shift_rate for p in self.plans], np.float64)
        n_t = np.arange(geo.taps_length)
        self._coarse = np.zeros(self.rows, np.int32)
        self._coarse[:self.num_channels] = [p.coarse_bins for p in self.plans]
        self._residual64 = np.zeros(self.rows, np.float64)
        self._residual64[:self.num_channels] = \
            [p.residual_cycles for p in self.plans]

        try:
            from scipy import fft as _sfft
            _fft_rows = lambda a: _sfft.fft(a, n=geo.fft_size, axis=1)
        except ImportError:                     # pragma: no cover
            _fft_rows = lambda a: np.fft.fft(a, n=geo.fft_size, axis=1) \
                .astype(np.complex64)

        def _taps_chunk(i, j):
            return (proto[None, :]
                    * np.exp(2j * np.pi * centers[i:j, None] * n_t[None, :])
                    ).astype(np.complex64)

        chunk = max(1, min(self.num_channels, (64 << 20) // (8 * geo.fft_size)))
        L = geo.fft_inv_size
        n = geo.fft_size
        if window_images is None:
            # smallest even image count whose centered window contains
            # every above-threshold bin of every channel's kernel FFT
            # (same criterion as select_window_images, computed per row
            # without the per-candidate-w loop)
            threshold = 1e-4
            w_need = 2
            for i in range(0, self.num_channels, chunk):
                f = _fft_rows(_taps_chunk(i, i + chunk))
                mags = np.abs(f)
                over = mags > threshold * mags.max()
                rows_i, bins = np.nonzero(over)
                rel = (bins - self._coarse[i + rows_i] + n // 2) % n - n // 2
                half = max(int(np.max(rel)) + 1, int(-np.min(rel)))
                w_need = max(w_need, 2 * -(-half // L))
            window_images = w_need
        self.window_images = w = max(2, min(int(window_images), decimation))
        m = np.arange(w * L)
        idx = (self._coarse[:, None] - (w // 2) * L + m[None, :]) % n
        self._idx_np = idx.astype(np.int32)                    # (rows, W)
        self._hwin_np = np.zeros((self.rows, w * L), np.complex64)
        for i in range(0, self.num_channels, chunk):
            f = _fft_rows(_taps_chunk(i, i + chunk))
            self._hwin_np[i:i + chunk] = np.take_along_axis(
                f, idx[i:i + f.shape[0]], axis=1).astype(np.complex64)
        self._idx = jnp.asarray(self._idx_np)
        self._hwin = jnp.asarray(self._hwin_np)
        self._residual_dev = jnp.asarray(self._residual64.astype(np.float32))

        # frame-batch cap: peak per-frame working set is the (B, rows, W)
        # gather+product (x2 for gather result + product before fusion)
        # plus the (B, N) frames/spectrum pair.  The budget trades device
        # memory for fewer, larger channelize dispatches per second of
        # stream.
        budget = int(os.environ.get('DUMPHFDL_CHZ_BUDGET_MB', '1024')) << 20
        per_frame = 2 * 8 * self.rows * w * L + 2 * 8 * geo.fft_size
        self._max_frames = max(1, min(64, 1 << int(np.log2(
            max(1, budget // per_frame)))))

        # wideband ring: fits the largest batch window + a big upload.
        # ALL ring cursors are carried ON DEVICE as (1, 1) i32 scalars the
        # host never reads back: every jitted step advances its own cursor,
        # so the streaming path needs zero per-call index uploads.  The
        # host mirrors fill counts as plain ints for control flow only.
        # Ring buffers allocate lazily (_ensure_rings): the superstep path
        # (dsp/superstep.py) carries its own tails and never touches them,
        # so engaging it must not cost half a GB of idle device rings.
        self._rw = 1 << int(np.ceil(np.log2(
            geo.overlap_length + (self._max_frames + 8) * geo.input_size + 1)))
        self._wb_ring = None
        self._wb_fill = geo.overlap_length   # pre-seeded overlap-save tail
        self._mixer_phase = jnp.zeros(self.rows, dtype=jnp.float32)

        # fs1 ring + polyphase resampler state
        self._out_count = 0            # total 5400-sps samples emitted
        self.ratio = self.fs1 / C.INTERNAL_RATE   # fs1 samples per output
        # ratio as an exact reduced rational: fs1/5400 = fs/(D*5400).
        # When the reduced terms are small (every practical SDR rate),
        # per-sample positions are derived with exact int32 arithmetic on
        # device, so phase-bin selection can never drift from the exact
        # float64 host computation (ADVICE r3: at pos ~ 1e4 the f32 ulp
        # ~1e-3 samples could flip a 1/64 phase bin near bin boundaries).
        import math as _math
        den0 = decimation * C.INTERNAL_RATE
        g = _math.gcd(self.fs, den0)
        self._rs_num = self.fs // g
        self._rs_den = den0 // g
        self._rs_exact = (self._rs_den <= (1 << 20)
                          and (out_chunk + 1) * self._rs_num < (1 << 30))
        self._rs_taps = int(8 * max(1, int(np.ceil(self.ratio))))
        self._bank = jnp.asarray(_resampler_bank(
            int(round(self.ratio * 1000)), self._rs_taps))
        need = int(out_chunk * self.ratio) + self._rs_taps \
            + (self._max_frames + 2) * geo.post_input_size + 64
        self._r1 = 1 << int(np.ceil(np.log2(need)))
        self._fs1_ring = None
        self._fs1_start = 0            # ring index of global sample _ring_global_start
        self._fs1_fill = 0             # valid samples in the ring
        self._ring_global_start = 0    # global fs1-sample index at _fs1_start

    def _ensure_rings(self) -> None:
        """Allocate the device rings on first streaming use (lazy: the
        superstep path never needs them)."""
        if self._wb_ring is not None:
            return
        geo = self.geo
        self._wb_ring = jnp.zeros((self._rw,), jnp.complex64)
        self._wb_wcur = jnp.asarray(
            np.asarray([[geo.overlap_length]], np.int32))  # after seeded tail
        self._wb_rcur = jnp.zeros((1, 1), jnp.int32)
        if self._fs1_ring is None:     # the sharded frontend installs its own
            self._fs1_ring = jnp.zeros((self.rows, self._r1), jnp.complex64)
            self._fs1_wcur = jnp.zeros((1, 1), jnp.int32)

    # ---- device kernels ----

    @functools.partial(jax.jit, static_argnums=(0,))
    def _wb_append(self, ring: jax.Array, x: jax.Array,
                   wpos: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Modular scatter of x at the device-carried write cursor;
        returns (ring', advanced cursor) -- no host index traffic."""
        cols = (wpos[0, 0] + jnp.arange(x.shape[0])) % ring.shape[0]
        return (ring.at[cols].set(x.astype(ring.dtype)),
                (wpos + x.shape[0]) % ring.shape[0])

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _channelize(self, ring: jax.Array, start: jax.Array, n_frames: int,
                    phase0: jax.Array, idxtab: jax.Array, hwin: jax.Array,
                    residual: jax.Array
                    ) -> tuple[jax.Array, jax.Array]:
        return self._channelize_body(ring, start, n_frames, phase0,
                                     idxtab, hwin, residual)

    def _channelize_body(self, ring: jax.Array, start: jax.Array,
                         n_frames: int, phase0: jax.Array, idxtab: jax.Array,
                         hwin: jax.Array, residual: jax.Array
                         ) -> tuple[jax.Array, jax.Array]:
        """n_frames overlap-save windows from the wideband ring ->
        (rows, n_frames*post_input_size) fs1 samples + new mixer phase.

        One fused XLA program: modular framing gather, batched forward
        FFT, per-channel bin-window gather x kernel window, image fold,
        batched inverse FFT (fft_inv_size), scrap, residual mixer.  Large
        tables (idxtab/hwin) ride as arguments, NOT closures: jit would
        embed closed-over device arrays in the program as constants."""
        geo = self.geo
        fr = (start[0, 0]
              + jnp.arange(n_frames, dtype=jnp.int32)[:, None] * geo.input_size
              + jnp.arange(geo.fft_size, dtype=jnp.int32)[None, :]) \
            % ring.shape[0]
        frames = ring[fr]                                      # (B, N)
        new_start = (start + n_frames * geo.input_size) % ring.shape[0]
        out, new_phase = self.ddc_frames(frames, phase0, idxtab, hwin,
                                         residual)
        return out, new_phase, new_start

    def ddc_frames(self, frames: jax.Array, phase0: jax.Array,
                   idxtab: jax.Array, hwin: jax.Array, residual: jax.Array
                   ) -> tuple[jax.Array, jax.Array]:
        """Core DDC on explicit (B, fft_size) overlap-save frames ->
        ((rows, B*post_input_size) fs1 samples, new mixer phase).  Plain
        traced math shared by the ring path, the offline helper, and the
        superstep engine (dsp/superstep.py)."""
        geo = self.geo
        w, L, D = self.window_images, geo.fft_inv_size, geo.decimation
        n_frames = frames.shape[0]
        spec = jnp.fft.fft(frames, axis=1)                     # (B, N)
        g = spec[:, idxtab]                                    # (B, rows, W)
        prod = g * hwin[None, :, :]
        folded = prod.reshape(n_frames, self.rows, w, L).sum(axis=2)
        # decimation-in-frequency fold; 1/D matches fastddc.c:194 norm
        time = jnp.fft.ifft(folded, axis=2) / D                # (B, rows, L)
        time = time[:, :, geo.scrap:]                          # scrap overlap
        out = time.transpose(1, 0, 2).reshape(self.rows, -1)
        # residual mixer (decimating_shift_addition equivalent).  The
        # coarse shift leaves |residual| <= v*D/(2N) cycles/sample, so the
        # f32 ramp stays small even over a 64-frame batch.
        n = out.shape[1]
        ph = phase0[:, None] + residual[:, None] * jnp.arange(n)[None, :]
        out = out * jnp.exp(-2j * jnp.pi * ph)
        new_phase = jnp.mod(phase0 + residual * n, 1.0)
        return out.astype(jnp.complex64), new_phase

    @functools.partial(jax.jit, static_argnums=(0,))
    def _fs1_append(self, ring: jax.Array, chunk: jax.Array,
                    wpos: jax.Array) -> tuple[jax.Array, jax.Array]:
        cols = (wpos[0, 0] + jnp.arange(chunk.shape[1])) % ring.shape[1]
        return (ring.at[:, cols].set(chunk.astype(ring.dtype)),
                (wpos + chunk.shape[1]) % ring.shape[1])

    @functools.partial(jax.jit, static_argnums=(0, 3), donate_argnums=(8,))
    def _channelize_append(self, ring, start, n_frames: int, phase0,
                           idxtab, hwin, residual, fs1_ring, fs1_wcur):
        """_channelize fused with the fs1-ring scatter: the steady-state
        frontend is ONE dispatch per frame batch instead of two."""
        out, new_phase, new_start = self._channelize_body(
            ring, start, n_frames, phase0, idxtab, hwin, residual)
        cols = (fs1_wcur[0, 0] + jnp.arange(out.shape[1])) % fs1_ring.shape[1]
        fs1_ring = fs1_ring.at[:, cols].set(out.astype(fs1_ring.dtype))
        return (fs1_ring, (fs1_wcur + out.shape[1]) % fs1_ring.shape[1],
                new_phase, new_start)

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _resample(self, ring: jax.Array, bank: jax.Array,
                  params: jax.Array, n_out: int) -> jax.Array:
        """Gather-interpolate n_out samples from the fs1 ring.

        Positions are computed ON DEVICE from three scalars packed in
        `params` (3, 1) f32 -- [frac start, int start, ring read cursor]
        -- so the per-drain host traffic is one tiny upload instead of
        two (n_out, 1) index vectors (a = global output position in fs1
        samples minus the ring's global start).

        Exact path (self._rs_exact, the practical case): params is
        [[a_frac_num], [a_int], [rstart]] int32 with a's fractional part
        as a numerator over the reduced ratio denominator; positions and
        phase bins come out of exact integer arithmetic.  Fallback path
        (irrational-ish sample rates): f32 positions -- worst case one
        1/64 phase-bin flip near bin boundaries (~-60 dB amplitude
        effect, below CS16 quantization)."""
        k = self._rs_taps
        if self._rs_exact:
            a_fnum = params[0, 0].astype(jnp.int32)
            a_int = params[1, 0].astype(jnp.int32)
            rstart = params[2, 0].astype(jnp.int32)
            num, den = self._rs_num, self._rs_den
            tot = a_fnum + jnp.arange(n_out, dtype=jnp.int32) * num
            base = tot // den
            rem = tot - base * den
            frac = rem.astype(jnp.float32) / jnp.float32(den)
            rel = jnp.maximum(a_int + base - (k // 2 - 1), 0)
        else:
            a_frac = params[0, 0]
            a_int = params[1, 0].astype(jnp.int32)
            rstart = params[2, 0].astype(jnp.int32)
            ratio = jnp.float32(self.ratio)
            pos = a_frac + jnp.arange(n_out, dtype=jnp.float32) * ratio
            base = jnp.floor(pos)
            frac = pos - base
            rel = jnp.maximum(a_int + base.astype(jnp.int32) - (k // 2 - 1), 0)
        offsets = (rstart + rel) % ring.shape[1]               # (n_out,)
        phases = jnp.round(frac * 64).astype(jnp.int32)
        win_idx = (offsets[:, None] + jnp.arange(k)[None, :]) % ring.shape[1]
        wins = ring[:, win_idx]                                # (C, n_out, K)
        taps = bank[phases]                                    # (n_out, K)
        return jnp.einsum('cok,ok->co', wins, taps,
                          precision=jax.lax.Precision.HIGHEST)

    # test/offline helper: channelize explicit (B, fft_size) frames
    def channelize_frames(self, frames, phase0=None):
        if phase0 is None:
            phase0 = jnp.zeros(self.rows, jnp.float32)
        return self._channelize_frames_jit(
            jnp.asarray(np.asarray(frames, np.complex64)), phase0,
            self._idx, self._hwin, self._residual_dev)

    @functools.partial(jax.jit, static_argnums=(0,))
    def _channelize_frames_jit(self, frames, phase0, idxtab, hwin, residual):
        return self.ddc_frames(frames, phase0, idxtab, hwin, residual)

    # ---- streaming API ----

    def ingest(self, samples) -> None:
        """Append wideband samples (numpy, or an already-uploaded device
        array from the prefetching ingest path) to the device ring."""
        self._ensure_rings()
        if isinstance(samples, jax.Array):
            x = samples
        else:
            x = jnp.asarray(np.asarray(samples, np.complex64))
        n = int(x.shape[0])
        if not n:
            return
        if self._wb_fill + n > self._rw:
            raise RuntimeError(
                f'wideband ring overflow: fill {self._wb_fill} + {n} '
                f'> {self._rw} (upload chunk too large for geometry)')
        self._wb_ring, self._wb_wcur = self._wb_append(
            self._wb_ring, x, self._wb_wcur)
        self._wb_fill += n

    def channelize_available(self) -> None:
        """Channelize every complete frame batch straight into the fs1
        ring (one fused dispatch per batch)."""
        geo = self.geo
        while (avail := (self._wb_fill - geo.overlap_length)
                // geo.input_size) > 0:
            # power-of-two batch (bounded compile-shape set, ADVICE r2 #3)
            n_now = 1 << int(np.log2(min(avail, self._max_frames)))
            n_out = n_now * geo.post_input_size
            if self._fs1_fill + n_out > self._r1:
                raise RuntimeError('fs1 ring overflow (consumer stalled)')
            (self._fs1_ring, self._fs1_wcur, self._mixer_phase,
             self._wb_rcur) = self._channelize_append(
                self._wb_ring, self._wb_rcur, n_now, self._mixer_phase,
                self._idx, self._hwin, self._residual_dev,
                self._fs1_ring, self._fs1_wcur)
            self._wb_fill -= n_now * geo.input_size
            self._fs1_fill += n_out

    def process_device(self, samples) -> list[jax.Array]:
        """Feed wideband samples; returns device-resident
        (rows, out_chunk) blocks at 5400 sps (>= 0 full chunks; remainder
        stays buffered on device).  Unfused path -- the fused streaming
        loop instead uses ingest() + channelize_available() + the
        resample-fused demod step (dsp/channel.py channel_step_fused)."""
        self.ingest(samples)
        self.channelize_available()
        return self._drain_resampler()

    # ---- fused steady-state support (resampler inside the demod step) ----

    @property
    def fused_ready(self) -> bool:
        """True when the exact-rational resampler cursor can be carried
        on device (int32-safe, incl. the a_int*den reconstruction in
        channel._rs_advance), enabling channel_step_fused."""
        return (bool(self._rs_exact)
                and self._r1 * self._rs_den < (1 << 30)
                and self.out_chunk % self._rs_den == 0)

    def rs_device_state(self) -> jax.Array:
        """(3, 1) i32 device cursor [a_frac_num, a_int, rstart] for the
        fused step; created lazily, then carried by the caller."""
        if getattr(self, '_rs_dev', None) is None:
            a_num = (self._out_count * self._rs_num
                     - self._ring_global_start * self._rs_den)
            a_int, a_fnum = divmod(a_num, self._rs_den)
            self._rs_dev = jnp.asarray(np.asarray(
                [[a_fnum], [a_int], [self._fs1_start]], np.int32))
        return self._rs_dev

    def chunk_ready(self) -> bool:
        """Enough fs1 samples buffered for one out_chunk resample?"""
        avail = self._ring_global_start + self._fs1_fill
        last_pos = (self._out_count + self.out_chunk - 1) * self.ratio
        return int(np.floor(last_pos)) + self._rs_taps < avail

    def consume_chunk(self, new_rs_state: jax.Array) -> None:
        """Mirror one fused-step resample in the host bookkeeping (the
        exact integer arithmetic the device cursor advance performs in
        channel.py:_rs_advance -- no readback)."""
        self._rs_dev = new_rs_state
        self._out_count += self.out_chunk
        num, den, k = self._rs_num, self._rs_den, self._rs_taps
        a_num = (self._out_count * num - self._ring_global_start * den)
        a_int = a_num // den
        drop = max(0, min(a_int - k, self._fs1_fill))
        if drop:
            self._fs1_start = (self._fs1_start + drop) % self._r1
            self._fs1_fill -= drop
            self._ring_global_start += drop

    def _append_fs1(self, chunk: jax.Array) -> None:
        """Append an (rows, n) fs1 chunk to the device ring."""
        self._ensure_rings()
        n = int(chunk.shape[1])
        if self._fs1_fill + n > self._r1:
            raise RuntimeError('fs1 ring overflow (consumer stalled)')
        self._fs1_ring, self._fs1_wcur = self._fs1_append(
            self._fs1_ring, chunk, self._fs1_wcur)
        self._fs1_fill += n

    def process(self, samples: np.ndarray) -> np.ndarray:
        """process_device + host materialization (offline/test use)."""
        chunks = self.process_device(samples)
        if not chunks:
            return np.zeros((self.rows, 0), dtype=np.complex64)
        return np.concatenate([np.asarray(c) for c in chunks], axis=1)

    def _drain_resampler(self) -> list[jax.Array]:
        """Emit as many out_chunk-sized resampled blocks as the fs1 ring
        allows.  The host computes only the block's float64 start position
        and uploads it as three scalars; per-sample positions/phases are
        derived on device (_resample)."""
        chunks: list[jax.Array] = []
        k = self._rs_taps
        while True:
            avail = self._ring_global_start + self._fs1_fill
            n0 = self._out_count
            last_pos = (n0 + self.out_chunk - 1) * self.ratio
            if int(np.floor(last_pos)) + k >= avail:
                break
            # a = fs1 position of output n0 relative to the ring start;
            # ring-bounded; exact path ships the fractional part as an
            # integer numerator over the reduced-ratio denominator
            if self._rs_exact:
                a_num = n0 * self._rs_num - self._ring_global_start * self._rs_den
                a_int, a_fnum = divmod(a_num, self._rs_den)
                params = np.asarray(
                    [[a_fnum], [a_int], [self._fs1_start]], np.int32)
            else:
                a = n0 * self.ratio - self._ring_global_start
                a_int = int(np.floor(a))
                params = np.asarray(
                    [[a - a_int], [a_int], [self._fs1_start]], np.float32)
            multi = isinstance(self._fs1_ring, jax.Array) \
                and not self._fs1_ring.is_fully_addressable
            chunks.append(self._resample(
                self._fs1_ring, np.asarray(self._bank) if multi
                else self._bank,
                params if multi else jnp.asarray(params),
                self.out_chunk))
            self._out_count += self.out_chunk
            # advance the ring read cursor (pure bookkeeping -- the ring is
            # modular, so freeing space is just moving the cursor)
            keep_from = int(np.floor(self._out_count * self.ratio)) - k
            drop = max(0, keep_from - self._ring_global_start)
            drop = min(drop, self._fs1_fill)
            if drop:
                self._fs1_start = (self._fs1_start + drop) % self._r1
                self._fs1_fill -= drop
                self._ring_global_start += drop
        return chunks
