"""Coset polyphase resampler vs the reference gather formulation.

channel._resample_ring decomposes the exact-rational resample into den
fixed-phase FIRs over stride-num slices (no gathers); it
must be BIT-EXACT vs the straightforward per-output gather (the
frontend._resample exact path) for every ratio in use, including ring
wraparound of the contiguous slab.
"""

import numpy as np
import jax.numpy as jnp

from dumphfdl_tpu.dsp.channel import _resample_ring
from dumphfdl_tpu.dsp.frontend import _resampler_bank


def _ref_resample(ring, bank, a_fnum, a_int, rstart, k, num, den, n_out):
    tot = a_fnum + np.arange(n_out) * num
    base = tot // den
    frac = (tot - base * den).astype(np.float32) / den
    rel = np.maximum(a_int + base - (k // 2 - 1), 0)
    offsets = (rstart + rel) % ring.shape[1]
    phases = np.round(frac * 64).astype(int)
    win = (offsets[:, None] + np.arange(k)[None, :]) % ring.shape[1]
    wins = ring[:, win]
    taps = np.asarray(bank)[phases]
    return np.einsum('cok,ok->co', wins, taps)


def test_coset_resampler_bit_exact():
    rng = np.random.default_rng(0)
    for num, den, k in ((5, 4, 16), (10, 9, 16), (25, 16, 16), (3, 2, 16)):
        r1 = 1 << 14
        ring = (rng.standard_normal((5, r1))
                + 1j * rng.standard_normal((5, r1))).astype(np.complex64)
        bank = _resampler_bank(int(round(num / den * 1000)), k)
        n_out = 5400 - (5400 % den)
        a_fnum, a_int, rstart = 2 % den, 37, 1200
        st = jnp.asarray([[a_fnum], [a_int], [rstart]], jnp.int32)
        got = np.asarray(_resample_ring(jnp.asarray(ring),
                                        jnp.asarray(bank), st,
                                        (k, num, den, n_out)))
        want = _ref_resample(ring, bank, a_fnum, a_int, rstart,
                             k, num, den, n_out)
        np.testing.assert_allclose(got, want, atol=1e-5,
                                   err_msg=f'ratio {num}/{den}')


def test_coset_resampler_ring_wrap():
    """The contiguous slab crossing the ring end must read the wrapped
    samples (the ring-extension concat path)."""
    rng = np.random.default_rng(1)
    r1 = 1 << 13
    ring = (rng.standard_normal((3, r1))
            + 1j * rng.standard_normal((3, r1))).astype(np.complex64)
    bank = _resampler_bank(1250, 16)
    st = jnp.asarray([[1], [20], [r1 - 300]], jnp.int32)
    got = np.asarray(_resample_ring(jnp.asarray(ring), jnp.asarray(bank),
                                    st, (16, 5, 4, 5400)))
    want = _ref_resample(ring, bank, 1, 20, r1 - 300, 16, 5, 4, 5400)
    np.testing.assert_allclose(got, want, atol=1e-5)
