"""Device byte histograms for the encode pipeline.

The encoder needs per-plane 256-bin histograms of the zigzag byte
planes (reference analogue: the zlib stage has no tables, but the rANS
stage's ``quantize_freqs`` input; see codec/ans.py), and per-channel
ones for segment tables.

For each value ``v = 16*h + l``, ``count[v] = sum_i onehot16(h_i) x
onehot16(l_i)``: two 16-wide one-hot compares per value and a (16, K)
@ (K, 16) product whose (h, l) cell counts the pairs. The bf16 one-hots
are exact (0/1), the product accumulates in float32 (exact below 2^24)
over blocks of at most 2^17 values, and blocks are summed in int32.
On an H100 this beat a scatter-add (``.at[].add``, atomics) over the
encoder's plane and channel rows together (PERF.md).

Rows are processed in blocks of at most 2^24 values (``lax.map``), so
the temporaries stay bounded whatever the batch.
"""

import jax
import jax.numpy as jnp


BLOCK = 1 << 17          # values per one-hot product (f32-exact: < 2^24)
ROW_BLOCK = 1 << 24      # values per row block


def _hist_block(v):
    """(rb, n) uint8 -> (rb, 256) int32 by one-hot products."""
    N, n = v.shape
    # Block size adapts to the row length (128-aligned): short rows
    # (e.g. per-channel histograms for segment tables) must not pad to
    # the full 2^17 block.
    block = min(BLOCK, max(128, -(-n // 128) * 128))
    nb = max(1, -(-n // block))
    pad = nb * block - n
    vp = jnp.pad(v, ((0, 0), (0, pad)))          # pads land in bin 0
    vb = jnp.moveaxis(vp.reshape(N, nb, block), 1, 0)

    def body(acc, blk):
        hi = jax.nn.one_hot(blk >> 4, 16, dtype=jnp.bfloat16)
        lo = jax.nn.one_hot(blk & 15, 16, dtype=jnp.bfloat16)
        pair = jnp.einsum('nki,nkj->nij', hi, lo,
                          preferred_element_type=jnp.float32)
        return acc + pair.reshape(N, 256).astype(jnp.int32), None

    acc, _ = jax.lax.scan(body, jnp.zeros((N, 256), jnp.int32), vb)
    return acc.at[:, 0].add(-pad)


@jax.jit
def histogram256(v):
    """Exact per-row byte histograms: (N, n) uint8 -> (N, 256) int32."""
    N, n = v.shape
    rb = max(1, min(N, ROW_BLOCK // max(n, 1)))
    nrb = -(-N // rb)
    blocks = jnp.pad(v, ((0, nrb * rb - N), (0, 0))).reshape(nrb, rb, n)
    return jax.lax.map(_hist_block, blocks).reshape(nrb * rb, 256)[:N]
