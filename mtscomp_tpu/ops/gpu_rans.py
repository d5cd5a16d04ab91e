"""Grouped rANS decode as one GPU program per group (Pallas, Triton route).

The XLA scan in ``ops/device_rans.py`` advances every group one step per
``lax.scan`` iteration; each step is several XLA kernels (three
gathers, a 4096-wide prefix sum, a word gather) and the lane states
make a round trip through device memory between them. Here one Triton
program decodes one group with the step loop inside:

- the group's 4096 lane states (32 rows x 128 lanes, row-major) stay in
  registers for the whole loop;
- the loop bound is the group's own longest row (``counts``), so a short
  ragged-tail group finishes early instead of scanning the batch's
  longest step count;
- a step's renorm ranks are one exclusive prefix sum over the 4096
  lanes of the block, and the underflowed lanes read their words from
  the contiguous window ``pos .. pos + sum(need)`` of the group stream;
- slot -> symbol is one gather from a per-row ``uint8`` table and
  frequency/cumulative is one gather from a packed per-row table. For
  tables whose boundaries are all multiples of 8 (every table this
  writer emits: ``models.rans.quantize_freqs``) the symbol table keeps
  one entry per 8 slots (``shift=3``): 16 KB per group instead of 128 KB.

Output is row-linear ``(N, 32, S*128)`` uint8 — entry ``(n, r, i)`` is
row ``r``'s symbol ``i`` — so segment reassembly needs no transpose.
Entries past a row's count are unspecified. Bit-identical to the
normative coder (``models/rans.py``) and to the XLA scan (tested in
interpret mode on the CPU; compiled only for the GPU).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.rans import SCALE_BITS, SCALE, RANS_L, LANES, GROUP_ROWS

GROUP_LANES = GROUP_ROWS * LANES          # 4096 lanes per group
NUM_WARPS = 16                            # fastest of 4/8/16 on an H100


def kernel_tables(freqs, cum, slot2sym, shift):
    """Packed lookup tables of the kernel from the XLA scan's tables.

    ``fc``: (N, R, 256) uint32 ``freq | cum << 13`` (freq <= 4096 needs
    13 bits, cum < 4096 needs 12). ``sym``: (N, R, 4096 >> shift) uint8
    slot -> symbol, one entry per ``1 << shift`` slots.
    """
    fc = (freqs.astype(jnp.uint32)
          | (cum.astype(jnp.uint32) << 13))
    sym = slot2sym[:, :, ::1 << shift].astype(jnp.uint8)
    return fc, sym


def _decode_kernel(states_ref, words_ref, sym_ref, fc_ref, counts_ref,
                   out_ref, used_ref, *, n_words, seg_len, shift):
    g = pl.program_id(0)
    lane = jnp.arange(GROUP_LANES, dtype=jnp.int32)
    row = lane >> 7
    col = lane & (LANES - 1)
    ts = SCALE >> shift
    cnt = counts_ref[g * GROUP_ROWS + row]
    n_max = jnp.max(counts_ref[pl.ds(g * GROUP_ROWS, GROUP_ROWS)])
    n_steps = (n_max + LANES - 1) // LANES
    sym_base = (g * GROUP_ROWS + row) * ts
    fc_base = (g * GROUP_ROWS + row) * 256
    out_base = (g * GROUP_ROWS + row) * seg_len + col
    w_base = g * n_words
    x0 = states_ref[pl.ds(g * GROUP_LANES, GROUP_LANES)]

    def step(s, carry):
        x, pos = carry
        active = s * LANES + col < cnt
        slot = (x & jnp.uint32(SCALE - 1)).astype(jnp.int32)
        sym = sym_ref[sym_base + (slot >> shift)].astype(jnp.int32)
        fc = fc_ref[fc_base + sym]
        f = fc & jnp.uint32(8191)
        c = fc >> 13
        upd = f * (x >> SCALE_BITS) + slot.astype(jnp.uint32) - c
        x = jnp.where(active, upd, x)
        need = active & (x < jnp.uint32(RANS_L))
        needi = need.astype(jnp.int32)
        rank = jnp.cumsum(needi) - needi
        idx = jnp.minimum(pos + rank, n_words - 1)
        w = plgpu.load(words_ref.at[w_base + idx], mask=need, other=0)
        x = jnp.where(need, (x << 16) | w.astype(jnp.uint32), x)
        out_ref[out_base + s * LANES] = sym.astype(jnp.uint8)
        return x, pos + jnp.sum(needi)

    _, pos = jax.lax.fori_loop(0, n_steps, step, (x0, jnp.int32(0)))
    used_ref[pl.ds(g, 1)] = jnp.full((1,), pos, jnp.int32)


@functools.partial(jax.jit, static_argnames=('n_steps', 'shift',
                                             'interpret', 'num_warps'))
def decode_groups_kernel(states, words, sym, fc, counts, *, n_steps,
                         shift=0, interpret=False, num_warps=NUM_WARPS):
    """Decode N groups; the kernel form of ``device_rans.decode_groups``.

    states (N, 32, 128) uint32; words (N, W) uint16 (zero-padded group
    streams); ``sym``/``fc`` from :func:`kernel_tables`; counts (N, 32)
    int32 symbols per row. ``n_steps`` only sizes the output rows
    (S*128 columns); each group loops over its own longest row.

    Returns ``(syms, words_used)``: (N, 32, S*128) uint8 row-linear
    symbols and the (N,) int32 stream words each group consumed.
    """
    N, R, K = states.shape
    assert R == GROUP_ROWS and K == LANES
    W = words.shape[1]
    seg_len = n_steps * LANES
    kernel = functools.partial(_decode_kernel, n_words=W, seg_len=seg_len,
                               shift=shift)
    syms, used = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((N * R * seg_len,), jnp.uint8),
                   jax.ShapeDtypeStruct((N,), jnp.int32)),
        grid=(N,),
        backend='triton',
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name='rans_decode_groups',
    )(states.reshape(-1), words.reshape(-1), sym.reshape(-1),
      fc.reshape(-1), counts.reshape(-1))
    return syms.reshape(N, R, seg_len), used
