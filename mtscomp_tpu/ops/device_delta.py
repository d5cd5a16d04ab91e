"""Device delta transform and inverse prefix scan (plain XLA ops).

Semantics identical to the host ops in ``ops/delta.py`` (reference:
mtscomp.py:143-169): first-order diff along time keeping row 0 verbatim,
and the in-dtype cumulative sum inverse. Integer exactness relies on
modular (wrapping) arithmetic: every op here stays in the integer
domain, where addition is exact in any order, so round trips are
byte-exact whatever summation order XLA picks.

All functions operate on batched chunks ``(B, T, C)``.
"""

import jax.numpy as jnp


def diff_time_jnp(x):
    """Batched time diff, row 0 kept: (B, T, C) -> (B, T, C)."""
    return jnp.concatenate([x[:, :1, :], x[:, 1:, :] - x[:, :-1, :]], axis=1)


def cumsum_time_jnp(d):
    """Inverse of :func:`diff_time_jnp` (in-dtype, wrapping)."""
    return jnp.cumsum(d, axis=1, dtype=d.dtype)


def diff_space_jnp(x):
    """Batched spatial diff, column 0 kept."""
    return jnp.concatenate([x[:, :, :1], x[:, :, 1:] - x[:, :, :-1]], axis=2)


def cumsum_space_jnp(d):
    return jnp.cumsum(d, axis=2, dtype=d.dtype)


def zigzag_decode_jnp(z, dtype):
    """Device inverse zigzag: uint codes -> original integer dtype."""
    bits = jnp.dtype(dtype).itemsize * 8
    u = z.astype(jnp.dtype('uint%d' % bits))
    s = (u >> 1) ^ (-(u & 1)).astype(u.dtype)
    return s.astype(jnp.dtype('int%d' % bits)).astype(dtype) \
        if jnp.dtype(dtype).kind == 'i' else s.astype(dtype)


def zigzag_encode_jnp(v):
    """Device zigzag: integer dtype -> uint codes of the same width."""
    bits = jnp.dtype(v.dtype).itemsize * 8
    s = v.astype(jnp.dtype('int%d' % bits))
    u = s.astype(jnp.dtype('uint%d' % bits))
    return (u * 2) ^ (s >> (bits - 1)).astype(u.dtype)
