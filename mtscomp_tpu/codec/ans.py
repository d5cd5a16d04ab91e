"""Format-v2 chunk codec: zigzag + byte planes + grouped 128-lane rANS.

Replaces the reference's zlib stage (mtscomp.py:394, 619) with an entropy
layout engineered for wide vector hardware (see models/rans.py for the
coder itself). Each chunk payload is fully self-contained (same
invariant as the zlib chunks), so random access, ``chop`` and the
offset-table format all work unchanged.

Layout of the element stream: integer elements are zigzag-mapped
(wrapped diffs become small codes) and split into ``itemsize`` byte
planes (LSB first); float elements skip zigzag. Each *coded* plane's
byte stream is cut into **segments** of ``2**seg_log2`` symbols; each
segment is one 128-lane interleaved rANS row; consecutive segments (in
plane-major order, across plane boundaries) are packed into **groups**
of up to 32 rows sharing one merged renorm-word stream in decoder
order.

Chunk container layout (all little-endian)::

    header (20 bytes):
      u32  magic   = 0x3253544D ("MTS2")
      u8   container version (2)
      u8   n_planes (= dtype itemsize)
      u8   flags   (bit0: zigzag applied to elements,
                    bit1: first row stored verbatim,
                    bit2: channel-aligned segments — requires bit1)
      u8   scale_bits (12)
      u32  n_elems (elements in the chunk)
      u8   seg_log2 (bit2 clear: symbols per segment = 1 << seg_log2;
                     bit2 set: k = channels per segment)
      u8   min_freq (8)
      u8   group_rows (segments per group, 32)
      u8   reserved
      u16  n_head (elements stored verbatim = n_channels when bit1)
      u16  reserved2
    [if flags bit1] head: n_head raw little-endian elements (row 0 of the
      chunk — after a time diff this row holds raw sample amplitudes
      whose byte statistics would poison the diff planes' tables)
    per plane p (planes cover the remaining n_elems - n_head elements):
      u8 mode:
        0 RAW   -> n_elems raw bytes
        1 RANS  -> u16 freq[256]           (flags bit4 clear)
                -> u8 n_tables, n_tables x u16 freq[256],
                   [if n_tables > 1] u8 table_idx[n_segments]
                                           (flags bit4: multi-table)
        2 CONST -> u8 value
    if any plane is RANS:
      u32 n_groups
      u32 n_words[g] for g in range(n_groups)
      per group g:
        u32 state[R_g * 128]      (R_g = rows in group, 32 except last)
        u16 word[n_words[g]]

Segments are derived, not stored: RANS planes in index order contribute
``ceil(n_coded / seg)`` segments each; the flat list is grouped by
``group_rows``.

Channel-aligned mode (flags bit2, the device fast layout): with
``C = n_head`` channels and ``Tcs = n_coded / C`` diffed samples per
channel, each channel's plane stream is padded with zero symbols to
``Tp = ceil(Tcs / 128) * 128`` and segments hold ``k`` whole channels
(``seg = k * Tp``). Decoded rows then ARE the (channel, time) layout —
the device pipeline reshapes instead of re-gathering. Pads cost a few
hundredths of a bit per symbol; decoders drop them by slicing
``(C, Tp)[:, :Tcs]``.
"""

import struct
import sys
import zlib

import numpy as np

from .buffers import dest_matches
from ..models import rans

MAGIC = 0x3253544D
CONTAINER_VERSION = 2
MODE_RAW, MODE_RANS, MODE_CONST = 0, 1, 2

# flags bit3: a little-endian u32 CRC32 of the whole preceding payload
# trails the container. The rANS stream has no intrinsic redundancy (a
# flipped word decodes to plausible garbage), so the checksum provides
# the corruption detection zlib chunks get from adler32. Decoders verify
# when the bit is set; files written before the bit existed lack it and
# rely on the word-consumption audit plus `check()`'s SHA1s.
FLAG_CRC32 = 8

# flags bit4: multi-table planes. Each RANS plane's metadata becomes
#   u8 mode=1, u8 n_tables, n_tables x u16 freq[256],
#   [if n_tables > 1] u8 table_idx[n_segments]
# so different segments of one plane can carry different frequency
# tables (the group coders are per-row-table already — this is purely a
# container extension). Recordings with per-channel amplitude gradients
# (LFP bands) compress measurably better with channel-aligned segments
# assigned to clustered tables; see cluster_segment_tables.
FLAG_MULTITABLE = 16

# flags bit5: per-chunk transform descriptor. The header's first
# reserved byte (offset 15) carries how THIS chunk was transformed:
# bits 0-1 = time-diff order (0 none, 1, 2), bit 2 = spatial diff.
# Written by adaptive writers (``transform_adapt``), whose periodic
# probe may change the transform mid-recording as the signal drifts;
# every chunk stays self-describing, so chop/merge/random access need
# no extra state and mixing adaptive with static chunks in one file is
# safe. Decoders must honor the descriptor over the sidecar's global
# transform keys whenever the bit is set (absent bit = sidecar
# semantics, i.e. every pre-bit5 file decodes unchanged).
FLAG_TRANSFORM = 32

# flags bit6: ragged-tail segment split. When the channel-aligned
# layout leaves ONE short remainder segment per plane (C % k leftover
# channels) and that segment would occupy a 32-row group alone
# (n_segs % group_rows == 1), the whole group scans the tail's full
# step count with 1 live row — and on the stacked device decoder the
# tail's step count gates its whole cell. With bit6 the ragged
# segment is instead emitted as M sub-segments (the header's trailing
# reserved u16 carries M), each a contiguous 128-aligned symbol range
# of the same channels: the tail group becomes M short rows, so its
# cell scans ~tail/M steps. Coding is unchanged (groups are generic
# over segment lists); only the segment DERIVATION differs, so every
# decoder follows the header bit symmetrically. Cost: (M-1) extra
# state blocks (512 B each) — ~0.05% of a headline chunk.
FLAG_TAILSPLIT = 64

DEFAULT_SEG_LOG2 = 16           # 65536 symbols per segment


def _crc32(buf, crc=0):
    """zlib-compatible CRC32, through the native PCLMUL folder when the
    buffer is big enough to amortize the FFI call (~6x zlib on the
    multi-MB group blobs; identical result by construction and by
    test)."""
    if len(buf) >= 65536:
        from ..native import crc32 as native_crc32
        got = native_crc32(buf, crc)
        if got is not None:
            return got
    return zlib.crc32(buf, crc)


def _parts_with_crc(parts):
    """Container parts plus the trailing CRC32 part.

    The CRC accumulates across parts; callers that can write parts
    sequentially (the Writer) skip joining the multi-MB container
    entirely — byte-wise the stream is identical to the joined form.
    """
    crc = 0
    for p in parts:
        crc = _crc32(p, crc)
    return parts + [struct.pack('<I', crc)]


def _append_crc(parts):
    """Join container parts with the trailing CRC32 appended."""
    return b''.join(_parts_with_crc(parts))

_HEADER = struct.Struct('<IBBBBIBBBBHH')
assert _HEADER.size == 20


def peek_desc(payload):
    """``(transform, tail_split)`` from a container's 20-byte header.

    The single header-peeking helper for callers that group or route
    chunks without a full parse (e.g. bulk-decode run grouping):
    format-layout knowledge stays here, validation matches
    :func:`peek_transform`. Malformed/foreign headers read as
    ``(None, 1)`` and fail loudly in the full parse instead.
    """
    if len(payload) < _HEADER.size:
        return None, 1
    fields = _HEADER.unpack_from(payload, 0)
    if fields[0] != MAGIC or fields[1] != CONTAINER_VERSION:
        return None, 1
    tsplit = int(fields[11]) if fields[3] & FLAG_TAILSPLIT else 1
    return peek_transform(payload), tsplit


def peek_transform(payload):
    """Per-chunk transform descriptor of a container, or None.

    Reads only the 20-byte header (flags bit5 + the reserved byte) —
    the Reader's inverse-transform sites call this on EVERY ans chunk
    so adaptive chunks decode correctly even when the sidecar knows
    nothing about them (e.g. a merged file mixing adaptive and static
    parts). Returns ``(time_diff_order, spatial)`` or None; malformed
    headers return None and fail loudly in the full parse instead.
    """
    if len(payload) < _HEADER.size:
        return None
    (magic, version, _it, flags, _sb, _ne, _sl, _mf, _gr, tdesc,
     _nh, _r2) = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC or version != CONTAINER_VERSION:
        return None
    if not flags & FLAG_TRANSFORM:
        return None
    order = tdesc & 3
    if order == 3:
        # Reserved descriptor value: treat as malformed (None) — the
        # full parse raises on it; a peek-only consumer must never act
        # on a fabricated order-0 reading of a corrupt header.
        return None
    return (order, bool(tdesc & 4))


def split_planes(elements, zigzag):
    """Element vector -> (n_elems, itemsize) uint8 plane matrix (LSB first)."""
    if zigzag:
        elements = rans.zigzag_encode(elements)
    u = np.ascontiguousarray(elements)
    if u.dtype.byteorder == '>':  # pragma: no cover
        u = u.astype(u.dtype.newbyteorder('<'))
    return u.view(np.uint8).reshape(u.size, u.dtype.itemsize)


def join_planes(planes, dtype, zigzag):
    """Inverse of :func:`split_planes`."""
    dtype = np.dtype(dtype)
    flat = np.ascontiguousarray(planes).view(
        np.dtype('<u%d' % dtype.itemsize) if dtype.itemsize > 1 else np.uint8
    ).reshape(-1)
    if zigzag:
        return rans.zigzag_decode(flat.view('u%d' % dtype.itemsize), dtype)
    return flat.view(dtype)


def segment_counts(n_elems, seg, modes, tail_split=1):
    """Per-RANS-plane segment count and the flat (plane, start, n) list.

    ``tail_split=M`` (flags bit6) re-derives each plane's ragged LAST
    segment as up to M sub-segments of 128-aligned size (the last sub
    takes the remainder) — same symbols, same order, more rows. M=1 is
    the historical derivation; writers and readers must pass the same
    value (the container header carries it), or states/words parse at
    the wrong offsets and the CRC/word audits fire.
    """
    segments = []
    for p, mode in enumerate(modes):
        if mode != MODE_RANS:
            continue
        for start in range(0, n_elems, seg):
            n = min(seg, n_elems - start)
            if tail_split > 1 and n < seg:
                steps = -(-n // 128)
                q = -(-steps // tail_split) * 128
                off = 0
                while off < n:
                    sub = min(q, n - off)
                    segments.append((p, start + off, sub))
                    off += sub
            else:
                segments.append((p, start, n))
    return segments


def tail_split_for(aligned, modes, n_stream, seg):
    """Writer-side flags-bit6 decision: the sub-segment count M (1 = off).

    Engages exactly where the ragged tail hurts the stacked decoder: a
    single RANS plane whose segment list ends with one short segment
    that would sit ALONE in the last 32-row group (n_segs % 32 == 1) —
    the canonical 385-channel geometry. Shared by the host codec and
    the device batch encoder so both emit identical containers.
    MTSCOMP_ENC_TAILSPLIT=0 disables (A/B escape); =N overrides M.
    """
    import os
    env = os.environ.get('MTSCOMP_ENC_TAILSPLIT', '')
    if env.isdigit() and int(env) <= 1:
        return 1                       # 0 or 1 = disabled
    if not aligned:
        return 1
    if sum(1 for m in modes if m == MODE_RANS) != 1:
        return 1
    n_segs = -(-n_stream // seg)
    if n_segs < 2 or n_segs % rans.GROUP_ROWS != 1:
        return 1
    L = n_stream - (n_segs - 1) * seg
    if L >= seg:
        return 1
    tail_steps = -(-L // 128)
    if 2 * tail_steps > -(-seg // 128):
        return 1                   # tail not short enough to matter
    M = int(env) if env.isdigit() and int(env) > 1 else 8
    # Clamp to the format cap (the parser rejects > 256) and to the
    # tail's own step count (more rows than steps is pure overhead).
    return max(1, min(M, 256, tail_steps))


def aligned_geometry(n_coded, n_head, seg0):
    """Channel-aligned segment geometry (flags bit2).

    ``n_coded`` coded elements over ``C = n_head`` channels, with a
    nominal segment size ``seg0``. Returns ``(k, seg, tp, tcs,
    n_stream)``: channels per segment, symbols per segment, padded and
    true per-channel lengths, and the padded stream length. Shared by
    the host codec and the device batch encoder so the two stay
    byte-identical.
    """
    C = n_head
    tcs = n_coded // C
    tp = -(-tcs // rans.LANES) * rans.LANES
    # k multiples of 4 keep G*32*k a multiple of 128 so the decoded
    # rows view directly as 128-aligned channel blocks; capped near C
    # so tiny chunks don't carry empty lanes.
    k = min(252, max(4, 4 * (-(-seg0 // (4 * tp)))))
    k = min(k, max(4, -(-C // 4) * 4))
    return k, k * tp, tp, tcs, C * tp


def _estimated_rans_bytes(counts, freqs, n_elems, seg):
    """Container-cost estimate for the RAW-vs-RANS decision: table +
    per-segment states + Shannon payload under the quantized model."""
    nz = counts > 0
    bits = float(np.sum(counts[nz] * (rans.SCALE_BITS - np.log2(freqs[nz]))))
    n_segs = -(-n_elems // seg)
    return 512 + n_segs * (4 * rans.LANES) + bits / 8.0


def seg_freqs(parsed, p, start):
    """Frequency table for plane ``p``'s segment starting at ``start``.

    Single accessor shared by every decode path (host, native staging,
    device batch packer) so multi-table planes (flags bit4) and legacy
    single-table planes look the same to callers.
    """
    plane = parsed['planes'][p]
    tidx = plane.get('tidx')
    if tidx is not None:
        return plane['tables'][tidx[start // parsed['seg']]]
    return plane['freqs']


def _segment_histograms(stream, seg):
    """(n_segs, 256) int64 symbol histograms of consecutive segments.

    The native banked counter handles the common case (~5x bincount);
    the fallback per-segment uint8 bincount loop beats any
    key-building vectorization: bincount over uint8 slices is pure C
    with no temporaries, and segment counts are small (tens).
    """
    from ..native import hist_u8_segments
    native = hist_u8_segments(stream, seg)
    if native is not None:
        return native
    n = stream.size
    out = np.empty((-(-n // seg), 256), dtype=np.int64)
    for i, start in enumerate(range(0, n, seg)):
        out[i] = np.bincount(stream[start:start + seg], minlength=256)
    return out


def _quantize_rows(sums):
    """quantize_freqs_batch through the native fast path when available.

    Bit-identical to the normative ``rans.quantize_freqs_batch`` (the
    C++ side mirrors the float64 apportionment op by op and runs the
    reference steal loop literally); exists because clustering
    quantizes many small candidate stacks per Lloyd iteration, where
    the NumPy form pays ~25 array-op overheads per call.
    """
    from .. import native
    out = native.quantize_freqs_batch(sums, 1 << rans.SCALE_BITS,
                                      rans.MIN_FREQ)
    if out is not None:
        return out
    return rans.quantize_freqs_batch(sums)


def _quantize_clusters(sums):
    """Batched quantize_freqs tolerating single-symbol clusters.

    A cluster whose segments are all one constant byte (e.g. zero pads)
    still needs a >= 2-symbol table; borrow one count for a neighbor
    symbol, mirroring the device pipeline's placeholder tables.
    """
    sums = np.asarray(sums, dtype=np.int64).copy()
    fix = (sums > 0).sum(axis=1) < 2
    if fix.any():
        rows = np.nonzero(fix)[0]
        sums[rows, (np.argmax(sums[rows], axis=1) + 1) % 256] += 1
    return _quantize_rows(sums)


# Bits charged per symbol occurrence that a candidate table cannot code
# (frequency 0). Large enough that argmin never picks a non-covering
# table while some covering table exists (a segment's own cluster table
# always covers it), small enough that n_segs * seg * BIG stays finite.
_UNCODABLE_BITS = 1e6

_TABLE_CANDIDATES = (1, 2, 4, 8, 16)


def decide_plane(counts, n_pad, n_stream, n_coded, seg, table_mode,
                 seg_hists_fn=None):
    """Shared plane-mode decision: CONST / RAW / RANS (+ clustering).

    THE single cost model for both the host codec and the device batch
    encoder — the two must emit byte-identical containers, so the
    decision logic lives here once. ``counts`` is the unpadded data
    histogram; ``n_pad`` the zero pads the coded stream adds;
    ``seg_hists_fn`` lazily provides the padded stream's per-segment
    histograms for ``table_mode='segment'``. Returns ``(mode, ptables,
    tidx)`` with ``ptables``/``tidx`` set only for ``MODE_RANS``.
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.max() == counts.sum():
        return MODE_CONST, None, None
    scounts = counts.copy()
    scounts[0] += n_pad
    freqs = _quantize_rows(scounts[None])[0]
    cost = _estimated_rans_bytes(scounts, freqs, n_stream, seg)
    ptables, tidx = freqs[None], None
    if table_mode == 'segment' and n_stream > seg \
            and seg_hists_fn is not None:
        ctables, cidx, cbits = cluster_segment_tables(seg_hists_fn())
        n_segs = -(-n_stream // seg)
        ccost = (ctables.shape[0] * 512 + 1
                 + (n_segs if ctables.shape[0] > 1 else 0)
                 + n_segs * (4 * rans.LANES) + cbits / 8.0)
        if ctables.shape[0] > 1 and ccost < cost:
            cost = ccost
            ptables, tidx = ctables, cidx
    if cost >= n_coded:
        return MODE_RAW, None, None
    return MODE_RANS, ptables, tidx


def cluster_segment_tables(seg_hists, max_tables=16):
    """Cluster per-segment histograms into few quantized tables.

    Lloyd iterations under the *exact* objective — Shannon bits of each
    segment under each candidate quantized table plus the container
    overhead of extra tables (512 B each) and the per-segment index
    byte. Initial clusters are contiguous quantiles of the segments
    ordered by mean symbol value (zigzag codes: a monotone proxy for
    channel amplitude, the dominant axis of variation in ephys bands).
    Candidate cluster counts double upward and the search stops once
    the total cost worsens (it is unimodal in T in practice — the
    marginal entropy gain of a split shrinks while the table cost is
    linear), keeping the encoder's clustering overhead small.

    Returns ``(tables, tidx, payload_bits)``: a ``(T, 256)`` uint16
    stack, per-segment uint8 table indices, and the total coded bits of
    all segments under their assigned tables.
    """
    H = np.asarray(seg_hists, dtype=np.float64)
    n_segs = H.shape[0]
    assert n_segs >= 1
    sym = np.arange(256, dtype=np.float64)
    feat = (H * sym).sum(axis=1) / np.maximum(H.sum(axis=1), 1.0)
    order = np.argsort(feat, kind='stable')

    def penalties(tables):
        # (T, 256) bits-per-occurrence; uncodable symbols get BIG.
        t = np.asarray(tables, dtype=np.float64)
        pen = np.full(t.shape, _UNCODABLE_BITS)
        nz = t > 0
        pen[nz] = rans.SCALE_BITS - np.log2(t[nz])
        return pen

    best = None
    for T in _TABLE_CANDIDATES:
        T = min(T, n_segs, max_tables, 255)
        # Contiguous equal-count split along the amplitude ordering.
        assign = np.empty(n_segs, dtype=np.int64)
        assign[order] = (np.arange(n_segs) * T) // n_segs
        for _ in range(5):
            _, assign = np.unique(assign, return_inverse=True)
            # Cluster sums as a one-hot matmul: counts are far below
            # 2^53, so the float64 product is exact (np.add.at's
            # scatter loop measured ~20x slower here).
            onehot = assign == np.arange(int(assign.max()) + 1)[:, None]
            sums = (onehot.astype(np.float64) @ H).astype(np.int64)
            tables = _quantize_clusters(sums)
            bits = H @ penalties(tables).T          # (n_segs, T_eff)
            new_assign = np.argmin(bits, axis=1)
            if np.array_equal(new_assign, assign):
                break
            assign = new_assign
        else:
            # Close with one assignment step under the final tables so
            # (tables, assign, bits) are mutually consistent.
            bits = H @ penalties(tables).T
            assign = np.argmin(bits, axis=1)
        used = np.unique(assign)
        tables = tables[used]
        remap = np.zeros(int(used.max()) + 1, dtype=np.int64)
        remap[used] = np.arange(used.size)
        assign = remap[assign]
        bits = H @ penalties(tables).T
        payload_bits = float(bits[np.arange(n_segs), assign].sum())
        T_eff = tables.shape[0]
        total = (T_eff * 512 + 1 + (n_segs if T_eff > 1 else 0)
                 + payload_bits / 8.0)
        if best is None or total < best[0]:
            best = (total, tables, assign.astype(np.uint8), payload_bits)
        elif total > best[0]:
            break                    # cost is rising: stop doubling T
        if T >= min(n_segs, max_tables, 255):
            break
    _, tables, tidx, payload_bits = best
    return tables, tidx, payload_bits


class AnsCodec:
    """Encode/decode one diffed chunk with grouped rANS byte planes."""

    name = 'ans'
    format_version = '2.0'

    def __init__(self, seg_log2=DEFAULT_SEG_LOG2, channel_aligned=True,
                 table_mode='plane', **kwargs):
        self.seg_log2 = int(seg_log2)
        assert 7 <= self.seg_log2 <= 24
        self.seg = 1 << self.seg_log2
        self.channel_aligned = bool(channel_aligned)
        if table_mode not in ('plane', 'segment'):
            raise ValueError("table_mode must be 'plane' or 'segment', "
                             "got %r." % (table_mode,))
        self.table_mode = table_mode

    # --- encode -----------------------------------------------------------

    def encode(self, chunkd, order='F', time_diff_pending=False,
               transform=None):
        """Encode one transformed chunk into one container bytestring."""
        return b''.join(self.encode_parts(
            chunkd, order=order, time_diff_pending=time_diff_pending,
            transform=transform))

    def encode_parts(self, chunkd, order='F', time_diff_pending=False,
                     transform=None):
        """Encode one transformed chunk into container parts.

        Returns the list of byte-like parts (CRC32 tail included) whose
        concatenation is the self-contained chunk container — the
        Writer streams the parts straight to the output file, skipping
        the multi-MB join of :meth:`encode`.

        With ``time_diff_pending=True`` the argument is the RAW chunk
        and the axis-0 time diff is still owed: the fast native prep
        applies it on the fly inside its blocked pass (saving the
        ``np.diff`` memory round trip); when that path declines, the
        diff is materialized and encoding restarts on the generic path.
        Output bytes are identical either way — callers (Writer,
        StreamWriter) use the flag whenever the transform is exactly
        the axis-0 diff.

        ``transform=(time_diff_order, spatial)`` stamps the per-chunk
        transform descriptor into the container (flags bit5 + the
        header's reserved byte) — adaptive writers pass the transform
        they actually applied to ``chunkd`` so each chunk is
        self-describing; ``None`` (the default) leaves the container
        byte-identical to pre-bit5 writers.
        """
        chunkd = np.asarray(chunkd)
        n_elems = chunkd.size
        itemsize = chunkd.dtype.itemsize
        zigzag = chunkd.dtype.kind in 'iu'
        # Row 0 is verbatim under the time-diff transform (raw sample
        # amplitudes); storing it raw keeps the diff planes' statistics
        # clean (see header docs). Only worthwhile for 2-D chunks with
        # more than one row and a head that fits the u16 field.
        split_head = chunkd.ndim == 2 and chunkd.shape[0] > 1 \
            and chunkd.shape[1] < 65536
        if split_head:
            head = np.ascontiguousarray(chunkd[0])
            n_head = head.size
        else:
            head = None
            n_head = 0
        n_coded = n_elems - n_head

        # Channel-aligned segments (flag bit2): pad each channel's plane
        # stream to a 128-multiple so decoded rows ARE the (C, T) layout.
        aligned = (self.channel_aligned and split_head and zigzag
                   and order == 'F' and n_coded > 0
                   and n_coded % n_head == 0)
        if aligned:
            C = n_head
            k, seg, tp, tcs, n_stream = aligned_geometry(
                n_coded, n_head, self.seg)
        else:
            seg = self.seg
            n_stream = n_coded

        # Fused native prep for the standard 2-byte aligned layout
        # (time diff when still pending + zigzag + byte split + pad +
        # transpose + histograms in one blocked pass — the encode
        # mirror of the fused decode finalize); the generic NumPy
        # pipeline handles everything else. In segment-table mode the
        # per-segment histograms (needed for clustering anyway) are
        # counted inside the same pass while the transposed rows are
        # still cache-resident — plane totals are the segment sums
        # minus the per-channel zero pads, bit-identical to
        # histogramming the padded stream separately.
        fast = None
        seg_hist_cache = {}
        seg_fast = (self.table_mode == 'segment' and aligned
                    and itemsize == 2 and n_stream > seg)
        if aligned and itemsize == 2:
            from .. import native
            if time_diff_pending:
                src, fuse_diff = np.ascontiguousarray(chunkd), True
            else:
                src, fuse_diff = np.ascontiguousarray(chunkd[1:]), False
            fast = native.prepare2_i16(src, tp, diff=fuse_diff,
                                       seg_k=k if seg_fast else 0)
            if fast is not None and seg_fast:
                n_pad = n_stream - n_coded
                n_segs = -(-C // k)
                # Native counts data symbols only; the padded stream's
                # per-channel zero tails land in bin 0 of each
                # segment's histogram (the last segment may hold fewer
                # channels).
                ch_in_seg = (np.minimum(np.arange(1, n_segs + 1) * k, C)
                             - np.arange(n_segs) * k)
                derived = []
                for p in range(2):
                    sh = fast[2 + p]
                    sh[:, 0] += ch_in_seg * (tp - tcs)
                    counts = sh.sum(axis=0)
                    counts[0] -= n_pad
                    if counts.max() != counts.sum():
                        # CONST planes never reach decide_plane; drop
                        # their histograms rather than keep them alive.
                        seg_hist_cache[p] = sh
                    derived.append(counts)
                fast = (fast[0], fast[1], derived[0], derived[1])
        if time_diff_pending and fast is None:
            # Fused-diff prep unavailable (no native library, or a
            # layout the fast path declines): materialize the diff and
            # restart on the generic path. diff_along_axis keeps row 0
            # verbatim, so head semantics are identical. The transform
            # descriptor MUST ride along — dropping it here once wrote
            # adaptive int32 chunks without their bit5 stamp while the
            # probed transform was still applied (silently corrupt
            # whenever the probe disagreed with the sidecar global;
            # found by the lifecycle storm).
            from ..ops.delta import diff_along_axis
            return self.encode_parts(diff_along_axis(chunkd, axis=0),
                                     order=order, transform=transform)
        if fast is None:
            elements = (chunkd[1:] if split_head else chunkd
                        ).ravel(order=order)
            planes = split_planes(elements, zigzag)

        modes, plane_info, streams = [], [], {}
        multitable = False
        for p in range(itemsize):
            if fast is not None:
                stream, counts = fast[p], fast[2 + p]
                plane = None
            else:
                plane = planes[:, p]
                counts = np.bincount(plane, minlength=256)
            if counts.max() == counts.sum():
                modes.append(MODE_CONST)
                # The constant byte: argmax of a one-hot histogram ==
                # the plane's single value. (Checked before building
                # the padded stream, which a CONST plane never needs.)
                plane_info.append(struct.pack('<BB', MODE_CONST,
                                              int(np.argmax(counts))))
                continue
            if fast is None:
                if aligned:
                    # Coded stream includes the per-channel zero pads.
                    stream = np.zeros(n_stream, dtype=np.uint8)
                    stream.reshape(C, tp)[:, :tcs] = plane.reshape(C, tcs)
                else:
                    stream = plane
            mode, ptables, tidx = decide_plane(
                counts, n_stream - n_coded, n_stream, n_coded, seg,
                self.table_mode,
                (lambda p=p: seg_hist_cache[p]) if p in seg_hist_cache
                else lambda s=stream: _segment_histograms(s, seg))
            if mode == MODE_RAW:
                modes.append(MODE_RAW)
                raw = (stream.reshape(C, tp)[:, :tcs].tobytes()
                       if plane is None else plane.tobytes())
                plane_info.append(struct.pack('<B', MODE_RAW) + raw)
            else:
                modes.append(MODE_RANS)
                streams[p] = np.ascontiguousarray(stream)
                plane_info.append((ptables, tidx))
                multitable = multitable or tidx is not None

        flags = (int(zigzag) | (2 if split_head else 0)
                 | (4 if aligned else 0)
                 | (FLAG_MULTITABLE if multitable else 0) | FLAG_CRC32)
        tdesc = 0
        if transform is not None:
            t_order, t_spatial = transform
            if not 0 <= int(t_order) <= 2:
                raise ValueError("transform order must be 0, 1 or 2 "
                                 "(got %r)." % (t_order,))
            flags |= FLAG_TRANSFORM
            tdesc = int(t_order) | (4 if t_spatial else 0)
        tsplit = tail_split_for(aligned, modes, n_stream, seg)
        if tsplit > 1:
            flags |= FLAG_TAILSPLIT
        seg_field = k if aligned else self.seg_log2
        parts = [_HEADER.pack(MAGIC, CONTAINER_VERSION, itemsize,
                              flags, rans.SCALE_BITS, n_elems,
                              seg_field, rans.MIN_FREQ,
                              rans.GROUP_ROWS, tdesc, n_head,
                              tsplit if tsplit > 1 else 0)]
        if split_head:
            h = head
            if h.dtype.byteorder == '>':  # pragma: no cover
                h = h.astype(h.dtype.newbyteorder('<'))
            parts.append(h.tobytes())
        rans_tables = {}
        for p, info in enumerate(plane_info):
            if isinstance(info, bytes):
                parts.append(info)
                continue
            ptables, tidx = info
            rans_tables[p] = info
            if multitable:
                meta = (struct.pack('<BB', MODE_RANS, ptables.shape[0])
                        + ptables.astype('<u2').tobytes())
                if ptables.shape[0] > 1:
                    meta += tidx.tobytes()
                parts.append(meta)
            else:
                parts.append(struct.pack('<B', MODE_RANS)
                             + ptables[0].astype('<u2').tobytes())

        def table_for(p, start):
            ptables, tidx = rans_tables[p]
            return ptables[0 if tidx is None else tidx[start // seg]]

        segments = segment_counts(n_stream, seg, modes, tail_split=tsplit)
        if segments:
            plane_bytes = streams
            group_inputs = []
            for g0 in range(0, len(segments), rans.GROUP_ROWS):
                group = segments[g0:g0 + rans.GROUP_ROWS]
                rows = [plane_bytes[p][start:start + n]
                        for p, start, n in group]
                freq_rows = np.stack([table_for(p, start)
                                      for p, start, _ in group])
                group_inputs.append((rows, freq_rows))
            encoded = self._encode_groups(group_inputs)
            group_blobs, word_counts = [], []
            le_host = sys.byteorder == 'little'
            for states, words in encoded:
                word_counts.append(words.size)
                if le_host:
                    # Native-endian arrays ARE the wire format here:
                    # hand zero-copy byte views to the single join in
                    # _append_crc instead of paying astype + tobytes +
                    # concat copies per group (the views keep the
                    # encoder's output arrays alive).
                    group_blobs.append(
                        memoryview(np.ascontiguousarray(states)).cast('B'))
                    group_blobs.append(
                        memoryview(np.ascontiguousarray(words)).cast('B'))
                else:  # pragma: no cover - big-endian host
                    group_blobs.append(states.astype('<u4').tobytes()
                                       + words.astype('<u2').tobytes())
            n_groups = len(encoded)
            parts.append(struct.pack('<I', n_groups))
            parts.append(np.asarray(word_counts, '<u4').tobytes())
            parts.extend(group_blobs)
        return _parts_with_crc(parts)

    def _encode_groups(self, group_inputs):
        """Encode groups via the native batch encoder when available."""
        from ..native import rans_encode_groups
        import multiprocessing
        out = rans_encode_groups(group_inputs,
                                 n_threads=multiprocessing.cpu_count())
        if out is not None:
            return out
        return [rans.rans_encode_group(rows, freq_rows)  # pragma: no cover
                for rows, freq_rows in group_inputs]

    # --- decode -----------------------------------------------------------

    def _check_geometry(self, parsed, n_samples, n_channels, dtype):
        n_elems = parsed['n_elems']
        if n_elems != n_samples * n_channels:
            raise IOError("ANS chunk has %d elements, expected %d."
                          % (n_elems, n_samples * n_channels))
        if parsed['itemsize'] != dtype.itemsize:
            raise IOError("ANS chunk itemsize %d does not match dtype %s."
                          % (parsed['itemsize'], dtype))

    @staticmethod
    def _alloc_bufs(parsed):
        return {p: np.empty(parsed['n_stream'], dtype=np.uint8)
                for p, plane in enumerate(parsed['planes'])
                if plane['mode'] == MODE_RANS}

    @staticmethod
    def _native_groups(parsed, bufs):
        """(states, words, freq_stack, row_views) per group — symbols
        land directly in the plane buffers (zero-copy row views)."""
        out = []
        for g in parsed['groups']:
            fq = np.stack([seg_freqs(parsed, p, start)
                           for p, start, _ in g['segments']])
            out.append((g['states'], g['words'], fq,
                        [bufs[p][start:start + n]
                         for p, start, n in g['segments']]))
        return out

    @staticmethod
    def _audit_words(groups, used_list):
        for group, used in zip(groups, used_list):
            if used != group['words'].size:
                raise IOError("ANS group consumed %d of %d payload words."
                              % (used, group['words'].size))

    def _decode_groups_numpy(self, parsed, bufs):
        """Normative NumPy coder path (also re-derives precise errors
        when the native decoder flags a corrupt stream)."""
        for g in parsed['groups']:
            freq_rows = np.stack([seg_freqs(parsed, p, start)
                                  for p, start, _ in g['segments']])
            rows, used = rans.rans_decode_group(
                g['states'], g['words'], freq_rows,
                [n for _, _, n in g['segments']])
            self._audit_words([g], [used])
            for (p, start, n), row in zip(g['segments'], rows):
                bufs[p][start:start + n] = row

    def decode(self, payload, n_samples, n_channels, dtype, order='F',
               n_threads=1):
        dtype = np.dtype(dtype)
        parsed = self.parse(payload)
        self._check_geometry(parsed, n_samples, n_channels, dtype)
        bufs = self._alloc_bufs(parsed)
        used_list = None
        if parsed['groups']:
            from .. import native
            if native.available():
                used_list = native.rans_decode_groups(
                    self._native_groups(parsed, bufs),
                    n_threads=max(1, int(n_threads)))
        if used_list is not None:
            self._audit_words(parsed['groups'], used_list)
        else:
            self._decode_groups_numpy(parsed, bufs)
        return self._finalize(parsed, bufs, n_samples, n_channels, dtype,
                              order)

    def decode_batch(self, payloads, shapes, dtype, order='F',
                     n_threads=1, outs=None):
        """Decode many chunk payloads with ONE native batch call.

        All chunks' groups are handed to the C++ decoder together, so
        its worker threads parallelize across the whole batch (the bulk
        ``tofile`` hot path); returns the diffed chunks like
        :meth:`decode` (the Reader applies the inverse delta).

        ``outs`` (optional) is a per-chunk list of destination arrays
        (C-contiguous, the chunk's shape/dtype) — bulk slice reads pass
        views of one span-wide array so the diffed chunks land in place
        and the caller skips its per-chunk concatenate copy. Entries
        may be None; fallback paths may still return fresh arrays, so
        callers must check identity.
        """
        dtype = np.dtype(dtype)
        if outs is None:
            outs = [None] * len(payloads)
        from .. import native
        if not native.available():
            return [self.decode(p, ns, nc, dtype, order=order)
                    for p, (ns, nc) in zip(payloads, shapes)]
        staged = []
        all_groups = []
        for payload, (ns, nc), out in zip(payloads, shapes, outs):
            parsed = self.parse(payload)
            self._check_geometry(parsed, ns, nc, dtype)
            bufs = self._alloc_bufs(parsed)
            all_groups.extend(self._native_groups(parsed, bufs))
            staged.append((parsed, bufs, ns, nc, out))
        if all_groups:     # RAW/CONST-only chunks have no rANS groups
            used_list = native.rans_decode_groups(
                all_groups, n_threads=max(1, int(n_threads)))
            if used_list is None:  # pragma: no cover - corrupt stream
                # Re-derive the precise per-chunk error via the slow path.
                return [self.decode(p, ns, nc, dtype, order=order)
                        for p, (ns, nc) in zip(payloads, shapes)]
            self._audit_words([g for parsed, _, _, _, _ in staged
                               for g in parsed['groups']], used_list)
        if int(n_threads) > 1 and len(staged) > 1:
            # Finalize chunks in parallel: outputs are disjoint arrays
            # and the hot work (the native fused finalize) releases the
            # GIL during the ctypes call.
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    min(int(n_threads), len(staged))) as ex:
                return list(ex.map(
                    lambda s: self._finalize(s[0], s[1], s[2], s[3],
                                             dtype, order, out=s[4]),
                    staged))
        return [self._finalize(parsed, bufs, ns, nc, dtype, order, out=out)
                for parsed, bufs, ns, nc, out in staged]

    def decode_channels(self, payload, n_samples, n_channels, dtype, cols,
                        n_threads=1):
        """Decode only the given channels of one chunk container.

        The channel-aligned layout (flags bit2) stores each channel's
        plane symbols contiguously, so a column subset only needs the
        rANS *groups* whose segments overlap the selected channels —
        for a 385-channel AP chunk a single channel touches ~1/13th of
        the groups, and the entropy stage is ~90% of decode time. The
        reference must always inflate whole chunks (one zlib stream per
        chunk, mtscomp.py:619).

        ``cols`` must be a sorted, unique, in-range array of channel
        indices. Returns a C-contiguous ``(n_samples, len(cols))``
        array of the *transformed* chunk (the caller applies the
        inverse time diff per column — columns are independent under
        the time diff), or ``None`` when the container layout does not
        support column-restricted decode (non-aligned, C order, no
        verbatim head): callers fall back to a full decode.
        """
        dtype = np.dtype(dtype)
        parsed = self.parse(payload)
        self._check_geometry(parsed, n_samples, n_channels, dtype)
        if not (parsed['aligned'] and parsed['n_head'] == n_channels
                and n_channels > 0 and n_samples > 1):
            return None
        cols = np.asarray(cols, dtype=np.int64)
        m = len(cols)
        tp, tcs = parsed['tp'], parsed['tcs']
        col_set = set(int(c) for c in cols)

        def overlaps(seg_):
            _, start, n = seg_
            return any(c in col_set
                       for c in range(start // tp, -(-(start + n) // tp)))

        needed = [g for g in parsed['groups']
                  if any(overlaps(s) for s in g['segments'])]
        if parsed['groups'] and len(needed) == len(parsed['groups']):
            # No entropy-stage saving (the selection touches every
            # group — e.g. few-segment LFP-geometry chunks): the
            # full-chunk path costs the same and feeds the LRU cache.
            return None
        bufs = self._alloc_bufs(parsed)
        if needed:
            sub = dict(parsed)
            sub['groups'] = needed
            used_list = None
            from .. import native
            if native.available():
                used_list = native.rans_decode_groups(
                    self._native_groups(sub, bufs),
                    n_threads=max(1, int(n_threads)))
            if used_list is not None:
                self._audit_words(needed, used_list)
            else:
                self._decode_groups_numpy(sub, bufs)

        planes = np.empty((m * tcs, parsed['itemsize']), dtype=np.uint8)
        for p, plane in enumerate(parsed['planes']):
            if plane['mode'] == MODE_CONST:
                planes[:, p] = plane['value']
            elif plane['mode'] == MODE_RAW:
                planes[:, p] = np.ascontiguousarray(plane['raw']).reshape(
                    n_channels, tcs)[cols].reshape(-1)
            else:
                planes[:, p] = bufs[p].reshape(
                    n_channels, tp)[cols, :tcs].reshape(-1)
        flat = join_planes(planes, dtype, parsed['zigzag'])
        out = np.empty((n_samples, m), dtype=dtype)
        out[0] = parsed['head'].view(
            dtype.newbyteorder('<')
            if dtype.byteorder == '>' else dtype)[cols]
        out[1:] = flat.reshape((n_samples - 1, m), order='F')
        return out

    def _finalize(self, parsed, bufs, n_samples, n_channels, dtype, order,
                  out=None):
        n_head = parsed['n_head']
        n_coded = parsed['n_elems'] - n_head
        # A provided destination must be exactly the chunk's layout to
        # be written in place; anything else falls back to a fresh
        # array (callers detect that by identity).
        dest = out if dest_matches(out, (n_samples, n_channels), dtype) \
            else None
        # Fused native finalize for the standard 2-byte aligned layout:
        # combine planes + inverse zigzag + pad-drop + transpose in one
        # blocked C pass (the host analogue of the device pipeline's
        # fused u8 finalize kernel); bit-identical to the NumPy path.
        if (parsed['aligned'] and parsed['zigzag'] and dtype.itemsize == 2
                and dtype.kind in 'iu' and n_head == n_channels
                and dtype.byteorder in '<='):
            from .. import native
            desc = []
            for p in range(2):
                pl = parsed['planes'][p]
                if pl['mode'] == MODE_CONST:
                    desc.append((2, pl['value']))
                elif pl['mode'] == MODE_RAW:
                    desc.append((1, np.ascontiguousarray(pl['raw'])))
                else:
                    desc.append((0, bufs[p]))
            out = dest if dest is not None \
                else np.empty((n_samples, n_channels), dtype=dtype)
            # Head bytes are stored little-endian; view with the
            # LE twin and let the assignment cast for '>' dtypes.
            out[0] = parsed['head'].view(
                dtype.newbyteorder('<')
                if dtype.byteorder == '>' else dtype)
            if native.fuse2_i16(desc[0], desc[1], n_channels,
                                parsed['tp'], parsed['tcs'], out[1:]):
                return out

        planes = np.empty((n_coded, parsed['itemsize']), dtype=np.uint8)
        for p, plane in enumerate(parsed['planes']):
            if plane['mode'] == MODE_CONST:
                planes[:, p] = plane['value']
            elif plane['mode'] == MODE_RAW:
                planes[:, p] = plane['raw']
        for p, buf in bufs.items():
            if parsed['aligned']:
                # Drop the per-channel zero pads.
                planes[:, p] = buf.reshape(
                    n_head, parsed['tp'])[:, :parsed['tcs']].reshape(-1)
            else:
                planes[:, p] = buf
        flat = join_planes(planes, dtype, parsed['zigzag'])
        if n_head:
            if n_head != n_channels:
                raise IOError("ANS chunk head has %d elements, expected "
                              "%d channels." % (n_head, n_channels))
            out = dest if dest is not None \
                else np.empty((n_samples, n_channels), dtype=dtype)
            # Head bytes are stored little-endian; view with the
            # LE twin and let the assignment cast for '>' dtypes.
            out[0] = parsed['head'].view(
                dtype.newbyteorder('<')
                if dtype.byteorder == '>' else dtype)
            out[1:] = flat.reshape((n_samples - 1, n_channels), order=order)
            return out
        if dest is not None:
            np.copyto(dest, flat.reshape((n_samples, n_channels),
                                         order=order))
            return dest
        return flat.reshape((n_samples, n_channels), order=order)

    # --- container parsing (shared with the device decode path) -----------

    def parse(self, payload):
        """Parse a chunk container into numpy views (no entropy decode).

        Raises IOError on any malformed container (bad magic/fields,
        truncation mid-structure, trailing bytes).
        """
        try:
            return self._parse(payload)
        except (IndexError, ValueError, struct.error) as e:
            # Out-of-range reads on truncated/garbage containers.
            raise IOError("Corrupt ANS chunk container: %s" % e)

    def _parse(self, payload):
        mv = memoryview(payload)
        if len(mv) < _HEADER.size:
            raise IOError("ANS chunk too short (%d bytes)." % len(mv))
        (magic, version, itemsize, flags, scale_bits, n_elems, seg_log2,
         min_freq, group_rows, _r1, n_head, _r2) = _HEADER.unpack_from(mv, 0)
        if magic != MAGIC:
            raise IOError("Bad ANS chunk magic 0x%08X." % magic)
        if version != CONTAINER_VERSION:
            raise IOError("Unsupported ANS container version %d." % version)
        if flags & FLAG_CRC32:
            if len(mv) < _HEADER.size + 4:
                raise IOError("ANS chunk too short for its CRC32 field.")
            (want,) = struct.unpack_from('<I', mv, len(mv) - 4)
            got = _crc32(mv[:-4])
            if got != want:
                raise IOError("ANS chunk CRC32 mismatch "
                              "(stored %08x, computed %08x)." % (want, got))
            mv = mv[:-4]
        if scale_bits != rans.SCALE_BITS:
            raise IOError("Unsupported ANS scale_bits %d." % scale_bits)
        if group_rows != rans.GROUP_ROWS:
            raise IOError("Unsupported ANS group_rows %d." % group_rows)
        off = _HEADER.size
        if not flags & 2:
            n_head = 0
        if n_head > n_elems:
            # Guard before any frombuffer: a negative n_coded would
            # turn count=-1 into "read the whole remaining buffer" and
            # desync the parser instead of raising.
            raise IOError("ANS chunk head (%d elements) exceeds its %d "
                          "total elements." % (n_head, n_elems))
        head = None
        if n_head:
            head = np.frombuffer(mv, np.uint8, n_head * itemsize, off)
            off += n_head * itemsize
        n_coded = n_elems - n_head
        aligned = bool(flags & 4)
        if aligned:
            if not n_head or n_coded % n_head:
                raise IOError("Channel-aligned ANS chunk without a valid "
                              "head geometry.")
            tcs = n_coded // n_head
            tp = -(-tcs // rans.LANES) * rans.LANES
            seg = seg_log2 * tp            # field holds k when aligned
            n_stream = n_head * tp
        else:
            tcs = tp = 0
            seg = 1 << seg_log2
            n_stream = n_coded
        if seg <= 0:
            raise IOError("ANS chunk has a zero-size segment geometry.")
        n_segs = -(-n_stream // seg)

        def read_table(off):
            freqs = np.frombuffer(mv, '<u2', 256, off)
            # Structural validation up front: every decoder (host,
            # native, XLA, Pallas) assumes a well-formed min-8
            # table; a corrupted one would otherwise decode garbage
            # silently or index out of range.
            nz = freqs[freqs > 0]
            if (int(freqs.sum()) != rans.SCALE or nz.size < 2
                    or int(nz.min()) < rans.MIN_FREQ):
                raise IOError("Corrupt ANS frequency table "
                              "(sum=%d, present=%d)."
                              % (freqs.sum(), nz.size))
            return freqs, off + 512

        planes, modes = [], []
        for _p in range(itemsize):
            mode = mv[off]; off += 1
            modes.append(mode)
            if mode == MODE_CONST:
                planes.append({'mode': mode, 'value': mv[off]})
                off += 1
            elif mode == MODE_RAW:
                raw = np.frombuffer(mv, np.uint8, n_coded, off)
                planes.append({'mode': mode, 'raw': raw})
                off += n_coded
            elif mode == MODE_RANS and flags & FLAG_MULTITABLE:
                n_tables = mv[off]; off += 1
                if n_tables < 1:
                    raise IOError("ANS multi-table plane with 0 tables.")
                tables = np.empty((n_tables, 256), dtype=np.uint16)
                for t in range(n_tables):
                    tables[t], off = read_table(off)
                if n_tables > 1:
                    tidx = np.frombuffer(mv, np.uint8, n_segs, off)
                    off += n_segs
                    if int(tidx.max(initial=0)) >= n_tables:
                        raise IOError(
                            "ANS table index %d out of range (%d tables)."
                            % (int(tidx.max()), n_tables))
                    planes.append({'mode': mode, 'tables': tables,
                                   'tidx': tidx})
                else:
                    planes.append({'mode': mode, 'freqs': tables[0]})
            elif mode == MODE_RANS:
                freqs, off = read_table(off)
                planes.append({'mode': mode, 'freqs': freqs})
            else:
                raise IOError("Unknown ANS plane mode %d." % mode)

        tsplit = 1
        if flags & FLAG_TAILSPLIT:
            tsplit = int(_r2)
            if not 2 <= tsplit <= 256:
                raise IOError("ANS chunk tail_split %d out of range."
                              % tsplit)
        segments = segment_counts(n_stream, seg, modes, tail_split=tsplit)
        groups = []
        if segments:
            (n_groups,) = struct.unpack_from('<I', mv, off); off += 4
            expect = -(-len(segments) // rans.GROUP_ROWS)
            if n_groups != expect:
                raise IOError("ANS chunk has %d groups, expected %d."
                              % (n_groups, expect))
            word_counts = np.frombuffer(mv, '<u4', n_groups, off)
            off += 4 * n_groups
            for g in range(n_groups):
                segs = segments[g * rans.GROUP_ROWS:
                                (g + 1) * rans.GROUP_ROWS]
                R = len(segs)
                states = np.frombuffer(mv, '<u4', R * rans.LANES, off)
                off += 4 * R * rans.LANES
                nw = int(word_counts[g])
                words = np.frombuffer(mv, '<u2', nw, off)
                off += 2 * nw
                groups.append({'segments': segs,
                               'states': states.reshape(R, rans.LANES),
                               'words': words})
        if off != len(mv):
            raise IOError("ANS chunk has %d trailing bytes." % (len(mv) - off))
        transform = None
        if flags & FLAG_TRANSFORM:
            t_order = _r1 & 3
            if t_order == 3:
                raise IOError("ANS chunk transform descriptor order 3.")
            transform = (t_order, bool(_r1 & 4))
        return {'itemsize': itemsize, 'n_elems': n_elems,
                'n_head': n_head, 'head': head,
                'zigzag': bool(flags & 1), 'seg_log2': seg_log2,
                'seg': seg, 'aligned': aligned, 'tcs': tcs, 'tp': tp,
                'n_stream': n_stream, 'transform': transform,
                'tail_split': tsplit,
                'modes': modes, 'planes': planes, 'groups': groups}
