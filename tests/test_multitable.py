"""Per-segment frequency tables (format v2 flags bit4).

Channel-heterogeneous recordings (LFP bands: amplitude varies across
the probe) compress better when channel-aligned segments carry
clustered frequency tables instead of one whole-plane table. These
tests cover the clustering encoder, every decode path, foreign-file
acceptance of the bit4 layout, and corruption detection.
"""

import struct
import zlib

import numpy as np
import pytest

from mtscomp_tpu import compress, decompress
from mtscomp_tpu.codec import ans as ans_mod
from mtscomp_tpu.codec.ans import AnsCodec
from mtscomp_tpu.models import rans

from conftest import write_arr


def hetero_signal(ns=4000, nc=96, seed=0):
    """int16 random walks whose step size sweeps 1..40 across channels
    (the amplitude gradient of an LFP band along a probe)."""
    rng = np.random.default_rng(seed)
    stds = np.logspace(0.0, 1.6, nc)
    d = rng.normal(0.0, 1.0, size=(ns, nc)) * stds
    return np.clip(np.cumsum(d, axis=0), -30000, 30000).astype(np.int16)


def _compress_files(tmp_path, arr, tag, **kwargs):
    raw = tmp_path / ('%s.bin' % tag)
    write_arr(raw, arr)
    out = tmp_path / ('%s.cbin' % tag)
    outmeta = tmp_path / ('%s.ch' % tag)
    compress(raw, out, outmeta, sample_rate=1000.0,
             n_channels=arr.shape[1], dtype=arr.dtype,
             algorithm='ans', quiet=True, **kwargs)
    return out, outmeta


def _first_payload(out, outmeta):
    r = decompress(out, outmeta, quiet=True)
    try:
        start, end = r.chunk_offsets[0], r.chunk_offsets[1]
        with open(out, 'rb') as f:
            return f.read()[start:end]
    finally:
        r.close()


def test_segment_tables_roundtrip_and_gain(tmp_path_):
    arr = hetero_signal()
    out_s, meta_s = _compress_files(tmp_path_, arr, 'seg',
                                    ans_table_mode='segment',
                                    ans_seg_log2=13)
    out_p, meta_p = _compress_files(tmp_path_, arr, 'pla',
                                    ans_table_mode='plane',
                                    ans_seg_log2=13)
    # The clustered tables must pay for themselves on this gradient.
    assert out_s.stat().st_size < out_p.stat().st_size
    # bit4 actually triggered, with >1 table on the low plane.
    payload = _first_payload(out_s, meta_s)
    parsed = AnsCodec(seg_log2=13).parse(payload)
    tidx = parsed['planes'][0].get('tidx')
    assert tidx is not None and parsed['planes'][0]['tables'].shape[0] > 1
    # Byte-exact round trip through the Reader (host decode path).
    r = decompress(out_s, meta_s, quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_segment_mode_on_homogeneous_data_is_byte_identical(tmp_path_):
    # iid channels: clustering gains nothing, the encoder keeps one
    # table per plane and the container is identical to 'plane' mode.
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.normal(0.0, 6.0, size=(4000, 64)),
                    axis=0).astype(np.int16)
    out_s, _ = _compress_files(tmp_path_, arr, 'seg',
                               ans_table_mode='segment')
    out_p, _ = _compress_files(tmp_path_, arr, 'pla',
                               ans_table_mode='plane')
    assert out_s.read_bytes() == out_p.read_bytes()


def test_segment_tables_all_decode_paths(tmp_path_, monkeypatch):
    arr = hetero_signal(seed=7)
    out, meta = _compress_files(tmp_path_, arr, 'seg',
                                ans_table_mode='segment',
                                ans_seg_log2=13)
    payload = _first_payload(out, meta)
    codec = AnsCodec(seg_log2=13)
    r = decompress(out, meta, quiet=True)
    try:
        ns = r.chunk_bounds[1] - r.chunk_bounds[0]
        chunk0 = arr[:ns]
        # Chunk payloads hold the diffed chunk; decode() inverts the
        # entropy+plane stages only, so compare against the diff.
        diffed = np.concatenate([chunk0[:1],
                                 np.diff(chunk0, axis=0)], axis=0)
        # 1) native C++ batch decoder (default host path).
        from mtscomp_tpu import native
        if native.available():
            got = codec.decode(payload, ns, arr.shape[1], arr.dtype)
            assert np.array_equal(got, diffed)
        # 2) normative NumPy coder.
        monkeypatch.setattr(native, 'available', lambda: False)
        got = codec.decode(payload, ns, arr.shape[1], arr.dtype)
        assert np.array_equal(got, diffed)
        monkeypatch.undo()
        # 3) device batch pipeline (XLA scan on the CPU backend).
        from mtscomp_tpu.parallel.pipeline import decompress_to_array
        got = decompress_to_array(r)
        assert np.array_equal(got, arr)
        # 4) the GPU decode kernel in interpret mode.
        from mtscomp_tpu.parallel import pipeline
        monkeypatch.setattr(pipeline, 'DECODER', 'kernel')
        got = decompress_to_array(r)
        assert np.array_equal(got, arr)
    finally:
        r.close()


def _plane_spans(payload, parsed):
    """Byte offsets of each plane's metadata in a bit4-free container."""
    itemsize = parsed['itemsize']
    n_coded = parsed['n_elems'] - parsed['n_head']
    off = 20 + parsed['n_head'] * itemsize
    spans = []
    for p in range(itemsize):
        mode = payload[off]
        if mode == ans_mod.MODE_CONST:
            spans.append((off, off + 2))
            off += 2
        elif mode == ans_mod.MODE_RAW:
            spans.append((off, off + 1 + n_coded))
            off += 1 + n_coded
        else:
            spans.append((off, off + 1 + 512))
            off += 1 + 512
    return spans, off


def _promote_to_multitable(payload, codec):
    """Rewrite a single-table container into the bit4 T=1 layout.

    Emulates a foreign writer that always uses the multi-table plane
    layout; decoders must accept it.
    """
    parsed = codec.parse(payload)
    body = bytearray(payload[:-4])            # strip trailing CRC32
    spans, _ = _plane_spans(body, parsed)
    out = bytearray(body[:20])
    out[6] |= ans_mod.FLAG_MULTITABLE          # flags byte of the header
    pos = 20
    for (a, b), plane in zip(spans, parsed['planes']):
        out += body[pos:a]
        if plane['mode'] == ans_mod.MODE_RANS:
            out += bytes([ans_mod.MODE_RANS, 1]) + body[a + 1:b]
        else:
            out += body[a:b]
        pos = b
    out += body[pos:]
    return bytes(out) + struct.pack('<I', zlib.crc32(bytes(out)))


def test_foreign_multitable_single_table_layout(tmp_path_):
    arr = hetero_signal(seed=11)
    out, meta = _compress_files(tmp_path_, arr, 'pla',
                                ans_table_mode='plane')
    payload = _first_payload(out, meta)
    codec = AnsCodec()
    promoted = _promote_to_multitable(payload, codec)
    assert promoted != payload
    r = decompress(out, meta, quiet=True)
    try:
        ns = r.chunk_bounds[1] - r.chunk_bounds[0]
    finally:
        r.close()
    want = codec.decode(payload, ns, arr.shape[1], arr.dtype)
    got = codec.decode(promoted, ns, arr.shape[1], arr.dtype)
    assert np.array_equal(got, want)


def _tidx_span(payload, codec):
    """Locate the first plane's table-index bytes in a bit4 container."""
    parsed = codec.parse(payload)
    assert parsed['planes'][0].get('tidx') is not None
    n_tables = parsed['planes'][0]['tables'].shape[0]
    off = 20 + parsed['n_head'] * parsed['itemsize']
    off += 2 + 512 * n_tables                 # mode, n_tables, tables
    n_segs = -(-parsed['n_stream'] // parsed['seg'])
    return off, off + n_segs


def test_corrupt_table_index_detected(tmp_path_):
    arr = hetero_signal(seed=13)
    out, meta = _compress_files(tmp_path_, arr, 'seg',
                                ans_table_mode='segment',
                                ans_seg_log2=13)
    payload = _first_payload(out, meta)
    codec = AnsCodec(seg_log2=13)
    a, b = _tidx_span(payload, codec)
    # Flip one index byte: the trailing CRC32 catches it.
    tampered = bytearray(payload)
    tampered[a] ^= 0x40
    with pytest.raises(IOError, match='CRC32'):
        codec.parse(bytes(tampered))
    # Out-of-range index with a recomputed (valid) CRC: structural check.
    body = bytearray(payload[:-4])
    body[a] = 255
    fixed = bytes(body) + struct.pack('<I', zlib.crc32(bytes(body)))
    with pytest.raises(IOError, match='table index'):
        codec.parse(fixed)


def test_cli_ans_tables_flag(tmp_path_):
    from mtscomp_tpu.cli import mtscomp as cli_compress
    from mtscomp_tpu.cli import mtsdecomp as cli_decompress
    arr = hetero_signal(seed=17)
    raw = tmp_path_ / 'cli.bin'
    write_arr(raw, arr)
    cli_compress([str(raw), '-d', 'int16', '-s', '1000', '-n',
                  str(arr.shape[1]), '-a', 'ans',
                  '--ans-tables', 'segment'])
    payload = _first_payload(tmp_path_ / 'cli.cbin', tmp_path_ / 'cli.ch')
    parsed = AnsCodec().parse(payload)
    assert parsed['planes'][0].get('tidx') is not None
    out = tmp_path_ / 'cli_out.bin'
    cli_decompress([str(tmp_path_ / 'cli.cbin'), '-o', str(out)])
    got = np.fromfile(out, dtype=np.int16).reshape(arr.shape)
    assert np.array_equal(got, arr)


def test_cluster_segment_tables_objective():
    # Two clearly distinct populations of segments -> exactly 2 tables,
    # every segment assigned to the table that codes it best.
    rng = np.random.default_rng(5)
    hists = []
    for i in range(12):
        if i % 2:
            syms = rng.integers(0, 4, size=5000)      # tight
        else:
            syms = rng.integers(0, 200, size=5000)    # broad
        hists.append(np.bincount(syms, minlength=256))
    tables, tidx, bits = ans_mod.cluster_segment_tables(np.stack(hists))
    assert tables.shape[0] == 2
    assert len(set(tidx[0::2])) == 1 and len(set(tidx[1::2])) == 1
    assert tidx[0] != tidx[1]
    for t in tables:
        assert int(t.sum()) == rans.SCALE
        nz = t[t > 0]
        assert int(nz.min()) >= rans.MIN_FREQ


def test_quantize_freqs_batch_matches_scalar():
    """The row-vectorized quantizer is bit-identical to the normative
    scalar one (same apportionment ordering and steal tie-breaking)."""
    rng = np.random.default_rng(11)
    rows = []
    for _ in range(60):
        kind = rng.integers(0, 3)
        if kind == 0:
            c = rng.integers(0, 1000, size=256)
        elif kind == 1:                          # sparse alphabets
            c = np.zeros(256, np.int64)
            idx = rng.choice(256, size=int(rng.integers(2, 9)),
                             replace=False)
            c[idx] = rng.integers(1, 100000, size=idx.size)
        else:                                    # heavy skew
            c = rng.integers(0, 3, size=256)
            c[int(rng.integers(0, 256))] = 10 ** 6
        if (c > 0).sum() < 2:
            c[:2] += 1
        rows.append(c)
    rows = np.stack(rows)
    batch = rans.quantize_freqs_batch(rows)
    for r in range(rows.shape[0]):
        assert np.array_equal(batch[r], rans.quantize_freqs(rows[r]))


def test_cluster_single_symbol_cluster():
    # A cluster of all-constant segments still yields a valid table.
    hists = np.zeros((4, 256), dtype=np.int64)
    hists[:2, 0] = 1000                        # constant segments
    hists[2:, :64] = 50                        # broad segments
    tables, tidx, _ = ans_mod.cluster_segment_tables(hists)
    for t in tables:
        assert int(t.sum()) == rans.SCALE
        assert np.count_nonzero(t) >= 2
    # Every segment's symbols are codable under its assigned table.
    for h, ti in zip(hists, tidx):
        assert np.all(tables[ti][h > 0] > 0)


def test_parse_rejects_oversized_head():
    """n_head > n_elems must raise IOError, not desync the parser."""
    codec = AnsCodec()
    chunkd = np.arange(400, dtype=np.int16).reshape(100, 4)
    payload = bytearray(codec.encode(chunkd, order='F'))
    # header: ... u32 n_elems at offset 8, u16 n_head at offset 16
    struct.pack_into('<H', payload, 16, 65535)
    body = bytes(payload[:-4])
    fixed = body + struct.pack('<I', zlib.crc32(body))
    with pytest.raises(IOError, match='head'):
        codec.parse(fixed)


def test_big_endian_dtype_roundtrip():
    """'>i2' input must round-trip by VALUE through the ans codec (the
    zigzag views need explicit byteorder normalization; confirmed lossy
    before the fix: 384 and 256 collided)."""
    rng = np.random.default_rng(21)
    chunkd = rng.integers(-30000, 30000, (500, 6)).astype('>i2')
    assert int(chunkd[0, 0]) == int(chunkd.astype('<i2')[0, 0])
    codec = AnsCodec()
    payload = codec.encode(chunkd, order='F')
    back = codec.decode(payload, 500, 6, np.dtype('>i2'), order='F')
    assert back.dtype == np.dtype('>i2')
    assert np.array_equal(back, chunkd)
    # The specific collision pair from the bug report.
    z = rans.zigzag_encode(np.array([384, 256], dtype='>i2'))
    assert z[0] != z[1]
    assert np.array_equal(
        rans.zigzag_decode(z, np.dtype('>i2')),
        np.array([384, 256], dtype='>i2'))
