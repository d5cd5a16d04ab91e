"""Chunk codec registry.

A codec turns one diffed chunk ``(n_samples_chunk, n_channels)`` into a
self-contained payload and back. Payload independence per chunk is the
format invariant that enables random access and ``chop``.

Available codecs:

- ``zlib`` — legacy format v1.0, byte-identical to the reference
  (deflate of the order-flattened diffed chunk, mtscomp.py:394).
- ``ans``  — format v2.0, interleaved-lane rANS designed for vectorized
  device decode.
"""

from .zlib_codec import ZlibCodec
from .ans import AnsCodec

_CODECS = {
    'zlib': ZlibCodec,
    'ans': AnsCodec,
}


def available_algorithms():
    return tuple(sorted(_CODECS))


def get_codec(name, **kwargs):
    """Instantiate a codec by algorithm name."""
    if name not in _CODECS:
        raise ValueError(
            "Unsupported algorithm %r; expected one of %s."
            % (name, ', '.join(available_algorithms())))
    return _CODECS[name](**kwargs)
