"""Batched grouped-rANS decode and encode as plain XLA programs.

Decodes N independent *groups* (GROUP_ROWS=32 segment rows x 128 lanes
each, see models/rans.py) simultaneously: one scan step advances all
N*32*128 lanes and consumes each group's merged word stream strictly
front-to-back. Bit-exact against the normative NumPy coder (tested);
the GPU kernel in ``ops/gpu_rans.py`` runs the same step with the loop
inside one program per group. The encode scan is the device encoder
on every platform.

Static shapes per call signature:

- ``states``  (N, 32, 128) uint32 — decoder start states (inactive rows L)
- ``words``   (N, W)      uint16 — merged renorm payload, zero-padded
- ``freqs``   (N, 32, 256) int32 — per-row frequency tables
- ``counts``  (N, 32)     int32  — symbols per row (0 for absent rows)

Output: (N, S, 32, 128) uint8 symbols; entry (n, s, r, j) is row r's
symbol ``s*128 + j`` (garbage where inactive).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.rans import SCALE_BITS, SCALE, RANS_L, LANES, GROUP_ROWS


def derive_tables(freqs):
    """cumfreq and dense slot->symbol tables from (N, R, 256) freqs.

    ``slot2sym[slot]`` counts the symbol upper bounds ``<= slot`` (f=0
    ties included): a scatter-add of one mark per upper bound and a
    prefix sum. Chosen on an H100 over a broadcast compare-reduce and a
    per-row binary search (PERF.md).
    """
    cum = jnp.cumsum(freqs, axis=-1) - freqs           # exclusive prefix
    upper = cum + freqs                                # (N, R, 256)
    n, r = upper.shape[:2]
    marks = jnp.zeros((n * r, SCALE + 1), jnp.int32)
    marks = marks.at[jnp.arange(n * r)[:, None],
                     upper.reshape(n * r, 256)].add(1)
    slot2sym = jnp.cumsum(marks[:, :SCALE], axis=1).reshape(n, r, SCALE)
    return cum, slot2sym


@functools.partial(jax.jit, static_argnames=('n_steps',))
def decode_groups(states, words, freqs, counts, *, n_steps):
    """Decode all groups for ``n_steps`` steps.

    Returns ``(syms, words_used)``: (N, S, 32, 128) uint8 symbols and the
    (N,) int32 count of stream words each group consumed — callers
    compare it against the group's stored stream length (the corruption
    check the sequential decoders perform inline).
    """
    N, R, K = states.shape
    assert R == GROUP_ROWS and K == LANES
    W = words.shape[1]
    freqs = freqs.astype(jnp.int32)
    cum, slot2sym = derive_tables(freqs)
    lane_j = jnp.arange(K, dtype=jnp.int32)

    def step(carry, s):
        x, pos = carry                            # (N,R,K) u32, (N,) i32
        active = (s * K + lane_j)[None, None, :] < counts[:, :, None]
        slot = (x & jnp.uint32(SCALE - 1)).astype(jnp.int32)
        sym = jnp.take_along_axis(slot2sym, slot, axis=2)
        f = jnp.take_along_axis(freqs, sym, axis=2).astype(jnp.uint32)
        c = jnp.take_along_axis(cum, sym, axis=2).astype(jnp.uint32)
        upd = f * (x >> SCALE_BITS) + slot.astype(jnp.uint32) - c
        x = jnp.where(active, upd, x)
        # Renorm: underflowed lanes read the next words in row-major
        # lane order across the whole group.
        need = (active & (x < jnp.uint32(RANS_L))).reshape(N, R * K)
        rank = jnp.cumsum(need, axis=1, dtype=jnp.int32) - need
        idx = jnp.minimum(pos[:, None] + rank, W - 1)
        w = jnp.take_along_axis(words, idx, axis=1).astype(jnp.uint32)
        xf = x.reshape(N, R * K)
        xf = jnp.where(need, (xf << 16) | w, xf)
        x = xf.reshape(N, R, K)
        pos = pos + jnp.sum(need, axis=1, dtype=jnp.int32)
        return (x, pos), sym.astype(jnp.uint8)

    # Derive pos0 from states so its sharding/vma matches inside
    # shard_map (a literal zeros carry trips the varying-axis check).
    pos0 = (states[:, 0, 0] & jnp.uint32(0)).astype(jnp.int32)
    (x, pos), syms = jax.lax.scan(
        step, (states, pos0), jnp.arange(n_steps, dtype=jnp.int32))
    return jnp.transpose(syms, (1, 0, 2, 3)), pos      # (N, S, R, K), (N,)


def _mulhi32(a, b):
    """High 32 bits of the u32 x u32 product (16-bit limb emulation)."""
    mask = jnp.uint32(0xFFFF)
    al, ah = a & mask, a >> 16
    bl, bh = b & mask, b >> 16
    p0 = al * bl
    mid = al * bh + (p0 >> 16)              # no overflow: < 2^32
    mid2 = mid + ah * bl                    # may wrap; detect carry
    carry = (mid2 < mid).astype(jnp.uint32)
    return ah * bh + (mid2 >> 16) + (carry << 16)


@functools.partial(jax.jit, static_argnames=('n_steps',))
def encode_groups(symbols, enc_pk, enc_rcp, counts, *, n_steps):
    """Encode N groups on device; the mirror of :func:`decode_groups`.

    symbols (N, R, S*128) uint8 — segment rows, zero-padded
    enc_pk  (N, R, 256)  uint32 — packed (rcp_shift, cmpl, cum) tables
    enc_rcp (N, R, 256)  uint32 — per-symbol reciprocals
    counts  (N, R)        int32 — symbols per row

    Tables come from :func:`mtscomp_tpu.models.rans.encoder_tables`;
    the state update is division-free (round-up reciprocal and a high
    multiply, exact for every 32-bit state).

    Returns ``(states, words_dense, emit)`` where ``states`` are the
    (N, R, 128) uint32 decoder start states and ``words_dense`` /
    ``emit`` are (S, N, R*128) uint16/bool — lax.scan stacks the step
    axis LEADING — in DECODER order (step ascending, row-major within a
    step): compact the step-major words per group (in order) to obtain
    the merged stream. Bit-identical to the normative encoder for the
    same inputs.
    """
    N, R, SK = symbols.shape
    K = LANES
    S = n_steps
    assert SK == S * K
    enc_pk = enc_pk.astype(jnp.uint32)
    enc_rcp = enc_rcp.astype(jnp.uint32)
    lane_j = jnp.arange(K, dtype=jnp.int32)
    syms_steps = jnp.transpose(
        symbols.reshape(N, R, S, K), (2, 0, 1, 3))         # (S, N, R, K)

    def step(x, inp):
        s, sy = inp                                        # scalar, (N,R,K)
        sy = sy.astype(jnp.int32)
        active = (s * K + lane_j)[None, None, :] < counts[:, :, None]
        pk = jnp.take_along_axis(enc_pk, sy, axis=2)
        rcp = jnp.take_along_axis(enc_rcp, sy, axis=2)
        c = pk & jnp.uint32(4095)
        cmpl = (pk >> 12) & jnp.uint32(8191)
        rshift = pk >> 25
        f = jnp.uint32(SCALE) - cmpl
        # Renormalize before the update: emit low 16 bits wherever the
        # update would overflow 32 bits.
        emit = active & (x >= (f << 20))
        word = (x & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        # q = x // f via the round-up reciprocal (exact for all u32 x);
        # update = x - q*f + q*SCALE + cum.
        t = _mulhi32(x, rcp)
        q = (((x - t) >> 1) + t) >> rshift
        x = jnp.where(active, x + c + q * cmpl, x)
        return x, (word.reshape(N, R * K), emit.reshape(N, R * K))

    # Derive x0 from an input so its sharding/vma matches inside
    # shard_map (a literal carry trips the varying-axis check; same
    # trick as decode_groups' pos0).
    x0 = jnp.broadcast_to(
        (counts[:, :, None].astype(jnp.uint32) & jnp.uint32(0))
        + jnp.uint32(RANS_L), (N, R, K))
    steps = jnp.arange(S - 1, -1, -1, dtype=jnp.int32)     # backward
    x, (words, emit) = jax.lax.scan(step, x0,
                                    (steps, syms_steps[::-1]))
    # Scan emitted steps S-1..0; flip to decoder (ascending) order.
    return x, words[::-1], emit[::-1]


def compact_words(words_dense, emit, n_words_max):
    """Device stream compaction: (S, N, RK) dense -> (N, W) merged stream.

    Scatter each emitted word to its rank (cumulative count in decoder
    order); masked slots get an index past the end and are dropped.
    Every written index is unique: on the GPU a scatter whose masked
    slots all share one in-bounds discard index serializes on it (no
    result within 35 s for 32 groups at the 385-channel geometry on an
    H100, against 2 ms with the masked slots dropped).
    """
    S, N, RK = words_dense.shape
    w = jnp.transpose(words_dense, (1, 0, 2)).reshape(N, S * RK)
    e = jnp.transpose(emit, (1, 0, 2)).reshape(N, S * RK)
    rank = jnp.cumsum(e, axis=1, dtype=jnp.int32) - e
    idx = jnp.where(e, rank, n_words_max)
    out = jnp.zeros((N, n_words_max), jnp.uint16)
    out = jax.vmap(lambda o, i, v: o.at[i].set(v, mode='drop'))(out, idx, w)
    return out, jnp.sum(e, axis=1, dtype=jnp.int32)


def pack_groups(groups, freq_of_segment):
    """Host-side padding of parsed container groups into batch arrays.

    ``groups``: list of parsed group dicts (codec.ans.parse output, may
    span several chunks). ``freq_of_segment``: callable (group_index, p,
    start) -> (256,) table of the segment of plane p starting at symbol
    ``start`` in that group's chunk (``codec.ans.seg_freqs``).

    Returns ``(states, words, freqs, counts, n_steps)``; per-group
    stream lengths are read from ``g['words'].size``.
    """
    N = len(groups)
    S = 0
    W = 1
    for g in groups:
        for _, _, n in g['segments']:
            S = max(S, -(-n // LANES))
        W = max(W, g['words'].size)
    W = 1 << max(0, (W - 1)).bit_length()              # pow2 bucket
    states = np.full((N, GROUP_ROWS, LANES), RANS_L, dtype=np.uint32)
    words = np.zeros((N, W), dtype=np.uint16)
    freqs = np.zeros((N, GROUP_ROWS, 256), dtype=np.int32)
    counts = np.zeros((N, GROUP_ROWS), dtype=np.int32)
    for i, g in enumerate(groups):
        R = len(g['segments'])
        states[i, :R] = g['states']
        words[i, :g['words'].size] = g['words']
        for r, (p, start, n) in enumerate(g['segments']):
            freqs[i, r] = freq_of_segment(i, p, start)
            counts[i, r] = n
    return states, words, freqs, counts, S


def decode_groups_host(groups, freq_of_segment):
    """Convenience wrapper: pack, decode on device, unpack row arrays.

    Raises IOError when a group consumes a different number of stream
    words than its container recorded (corrupt payload).
    """
    states, words, freqs, counts, S = pack_groups(groups, freq_of_segment)
    out, used = decode_groups(states, jnp.asarray(words),
                              jnp.asarray(freqs), jnp.asarray(counts),
                              n_steps=S)
    out = np.asarray(out)
    used = np.asarray(used)
    rows = []
    for i, g in enumerate(groups):
        if used[i] != g['words'].size:
            raise IOError("ANS group consumed %d of %d payload words."
                          % (used[i], g['words'].size))
        rows.append([out[i, :, r, :].reshape(-1)[:n]
                     for r, (_, _, n) in enumerate(g['segments'])])
    return rows
