"""Narrow-width host->device sample uploads.

Integer SDR samples cross to the device as packed int32 words (one
complex sample per word for CS16, two for CU8) and are converted to
complex64 on device: half (CS16) or a quarter (CU8) of the bytes of a
complex64 upload, and bit-exact with the host converters
(io/formats.py, input-helpers.c:10-78).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=('shape',))
def _unpack_i16(packed, shape: tuple):
    """i32 words of packed int16 pairs -> complex64 of `shape`.

    Each i32 holds one sample: high 16 bits = re, low 16 = im (signed)."""
    re = jnp.right_shift(packed, 16).astype(jnp.float32)
    im = (jnp.right_shift(jnp.left_shift(packed, 16), 16)).astype(jnp.float32)
    return (jax.lax.complex(re, im) * (1.0 / 32767.0)).reshape(shape)


def device_put_cs16(x: np.ndarray) -> jax.Array:
    """Upload complex samples as packed int16 pairs (half the bytes of a
    complex64 upload) and unpack on device.

    Quantizes to CS16 precision (~90 dB SNR at full scale), i.e. no worse
    than the reference's CS16 SDR input format (input-helpers.c:34-55);
    inputs are expected normalized to [-1, 1] full scale and are clipped."""
    x = np.asarray(x, np.complex64)
    re = np.clip(np.round(x.real * 32767.0), -32768, 32767).astype(np.int32)
    im = np.clip(np.round(x.imag * 32767.0), -32768, 32767).astype(np.int32)
    packed = (re << 16) | (im & 0xFFFF)
    return _unpack_i16(jnp.asarray(packed.reshape(-1)), x.shape)


@jax.jit
def _unpack_cs16_raw(packed):
    """(n,) i32 of packed int16 I/Q pairs -> (n,) complex64.

    Same reciprocal-multiply scaling as the native C++ converter
    (native/hfdl_host.cpp hfdl_convert_cs16); matches the numpy divide
    to 1 ULP."""
    re = jnp.right_shift(packed, 16).astype(jnp.float32)
    im = jnp.right_shift(jnp.left_shift(packed, 16), 16).astype(jnp.float32)
    scale = np.float32(1.0) / np.float32(32767.5)
    return jax.lax.complex(re * scale, im * scale)


def device_put_cs16_raw(raw: np.ndarray) -> jax.Array:
    """Upload raw interleaved int16 I/Q in native width (4 bytes/sample)
    and convert on device.

    The int16 values ride untouched; the full-scale conversion
    (input-helpers.c:34-55) happens in f32 on device, matching
    formats.convert(raw, 'CS16') to 1 ULP."""
    v = np.ascontiguousarray(raw).view(np.int16)
    re = v[0::2].astype(np.int32)
    im = v[1::2].astype(np.int32)
    return _unpack_cs16_raw(jnp.asarray((re << 16) | (im & 0xFFFF)))


@functools.partial(jax.jit, static_argnames=('n',))
def _unpack_cu8_raw(packed, n: int):
    """i32 words of 4 packed CU8 bytes -> (n,) complex64.

    Matches formats.convert(.., 'CU8') -- (byte - 63.5) / 127.0 -- to
    1 ULP."""
    def byte(k):
        return jnp.bitwise_and(
            jax.lax.shift_right_logical(packed, 8 * k), 0xFF
        ).astype(jnp.float32)

    re = jnp.stack([byte(0), byte(2)], axis=1).reshape(-1)[:n]
    im = jnp.stack([byte(1), byte(3)], axis=1).reshape(-1)[:n]
    scale = np.float32(127.0)
    off = np.float32(63.5)
    return jax.lax.complex((re - off) / scale, (im - off) / scale)


def device_put_cu8_raw(raw: np.ndarray) -> jax.Array:
    """Upload raw CU8 I/Q bytes in native width (2 bytes/sample) and
    convert on device (matches formats.convert(raw, 'CU8') to 1 ULP)."""
    b = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    n = b.size // 2                      # complex samples
    b = b[:2 * n]
    if b.size % 4:
        b = np.concatenate([b, np.zeros(2, np.uint8)])
    return _unpack_cu8_raw(jnp.asarray(b.view('<i4')), n)
