"""Periodic per-chunk transform adaptation (transform_adapt, flags bit5).

Windows of N chunks share their leader's probed transform; every
adaptive chunk self-describes via the container header, so decode never
consults the sidecar for them. Beyond-reference ratio feature: the
reference's transform is global (mtscomp.py:375-397) — a drifting
recording keeps chunk 0's choice forever there.
"""

import numpy as np
import pytest

from mtscomp_tpu import compress, decompress
from mtscomp_tpu.parallel.pipeline import _read_payload

from conftest import write_arr

SR, NC = 2000.0, 24


def drifting_signal(n_chunks=12, ns=2000, nc=NC, seed=0):
    """First half noise-dominated (order 1 wins), second half
    oscillatory LFP-like (order 2 wins)."""
    rng = np.random.default_rng(seed)
    half = ns * n_chunks // 2
    t = np.arange(half)
    noise = np.cumsum(rng.normal(0, 8, size=(half, nc)), axis=0)
    lfp = (800 * np.sin(2 * np.pi * 4 * t / 2000.0)[:, None]
           + np.cumsum(rng.normal(0, .6, size=(half, nc)), axis=0))
    return np.concatenate([noise, lfp]).astype(np.int16)


def _descs(r):
    return [r.codec.parse(_read_payload(r, i))['transform']
            for i in range(r.n_chunks)]


def test_adapt_ratio_gain_and_exactness(tmp_path_):
    arr = drifting_signal()
    path = write_arr(tmp_path_ / 'd.bin', arr)
    rs = compress(path, tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
                  sample_rate=SR, n_channels=NC, dtype='int16',
                  algorithm='ans', quiet=True)
    ra = compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                  sample_rate=SR, n_channels=NC, dtype='int16',
                  algorithm='ans', quiet=True, transform_adapt=4)
    # Static keeps chunk 0's order-1 choice for the LFP half; adaptive
    # switches at the window boundary -> strictly better ratio.
    assert 1 / ra > 1.05 * (1 / rs)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
        assert r.cmeta['transform_adapt'] == 4
        descs = _descs(r)
        assert all(d is not None for d in descs)
        assert descs[0][0] == 1 and descs[-1][0] == 2
        # Windows change only at window boundaries.
        for i, d in enumerate(descs):
            assert d == descs[(i // 4) * 4]
        # Random access + column reads ride the per-chunk descriptors.
        assert np.array_equal(r[2100:9500], arr[2100:9500])
        assert np.array_equal(r[:, 3], arr[:, 3])
        assert np.array_equal(r[:, 7:9], arr[:, 7:9])
    finally:
        r.close()


def test_adapt_bytes_deterministic_across_threads(tmp_path_):
    arr = drifting_signal(n_chunks=8)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    for i, nt in enumerate([1, 4]):
        compress(path, tmp_path_ / ('t%d.cbin' % i),
                 tmp_path_ / ('t%d.ch' % i), sample_rate=SR,
                 n_channels=NC, dtype='int16', algorithm='ans',
                 quiet=True, transform_adapt=3, n_threads=nt,
                 check_after_compress=False)
    assert (tmp_path_ / 't0.cbin').read_bytes() \
        == (tmp_path_ / 't1.cbin').read_bytes()


def test_adapt_stream_matches_batch_and_resume(tmp_path_):
    from mtscomp_tpu.stream import StreamWriter
    arr = drifting_signal(n_chunks=10)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=3,
             check_after_compress=False)
    with StreamWriter(tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans', transform_adapt=3) as w:
        for i in range(0, len(arr), 1500):
            w.append(arr[i:i + 1500])
    assert (tmp_path_ / 's.cbin').read_bytes() \
        == (tmp_path_ / 'b.cbin').read_bytes()
    # Crash-resume MID-WINDOW (5 chunks in, window size 3): the resumed
    # writer re-derives the window leader's probe from the decoded
    # leader chunk; the finished file must stay byte-identical.
    w = StreamWriter(tmp_path_ / 'r.cbin', tmp_path_ / 'r.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', transform_adapt=3,
                     live_sidecar=True)
    w.append(arr[:5 * 2000])
    w._fb.close()                      # simulated crash (no finalize)
    w._closed = True
    w2 = StreamWriter.resume(tmp_path_ / 'r.cbin', tmp_path_ / 'r.ch')
    try:
        w2.append(arr[5 * 2000:])
    finally:
        w2.close()
    assert (tmp_path_ / 'r.cbin').read_bytes() \
        == (tmp_path_ / 'b.cbin').read_bytes()
    with pytest.raises(ValueError, match='sidecar'):
        StreamWriter.resume(tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch',
                            transform_adapt=5)


def test_adapt_device_batch_uniform_windows(tmp_path_, monkeypatch, kernel_interpret):
    """Uniform-transform batches decode on the device path; a batch
    mixing transforms is declined (host decodes it exactly)."""
    from mtscomp_tpu.parallel.pipeline import DeviceBatchDecoder
    arr = drifting_signal(n_chunks=8)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=4,
             check_after_compress=False)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        descs = _descs(r)
        assert descs[0] != descs[4]     # the signal drifts mid-file
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(8)]
        dec = DeviceBatchDecoder(r)
        ns = r.chunk_bounds[1]
        assert not dec.supported(parsed, ns)          # mixed transforms
        assert dec.supported(parsed[:4], ns)          # uniform window
        assert dec.supported(parsed[4:], ns)
        out = dec.decode_batch(parsed[4:], ns)
        assert np.array_equal(out.reshape(-1, NC), arr[4 * 2000:])
    finally:
        r.close()


def test_adapt_guards(tmp_path_):
    from mtscomp_tpu import Writer
    from mtscomp_tpu.transcode import transcode
    with pytest.raises(ValueError, match='ans'):
        Writer(algorithm='zlib', transform_adapt=4)
    arr = drifting_signal(n_chunks=4)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=2,
             check_after_compress=False)
    with pytest.raises(ValueError, match='transform_adapt'):
        transcode(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                  tmp_path_ / 'o.cbin', tmp_path_ / 'o.ch',
                  transform_adapt=2, quiet=True)
    # Adaptive SOURCES transcode fine (the Reader undoes per-chunk
    # transforms before re-encoding).
    transcode(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
              tmp_path_ / 'z.cbin', tmp_path_ / 'z.ch',
              algorithm='zlib', quiet=True)
    r = decompress(tmp_path_ / 'z.cbin', tmp_path_ / 'z.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_adapt_chop_and_verify(tmp_path_):
    from mtscomp_tpu.verify import verify_file
    arr = drifting_signal(n_chunks=8)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=3,
             check_after_compress=False)
    assert verify_file(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                       deep=True, quiet=True)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        # Chop keeps chunks self-contained: the truncated file decodes
        # its surviving adaptive chunks from their own descriptors.
        r.chop(6, tmp_path_ / 'c.cbin')
    finally:
        r.close()
    rc = decompress(tmp_path_ / 'c.cbin', tmp_path_ / 'c.ch', quiet=True)
    try:
        assert np.array_equal(rc[:], arr[:6 * 2000])
    finally:
        rc.close()


def test_adapt_spatial_window_and_columns(tmp_path_):
    """A window whose leader picks the spatial diff: decodes exactly;
    column-restricted reads detect the per-chunk spatial flag and fall
    back to full-chunk decode (columns are coupled there)."""
    rng = np.random.default_rng(3)
    half = 4 * 2000
    indep = np.cumsum(rng.normal(0, 8, size=(half, NC)), axis=0)
    common = (np.cumsum(rng.normal(0, 60, size=(half, 1)), axis=0)
              + np.cumsum(rng.normal(0, .5, size=(half, NC)), axis=0))
    arr = np.concatenate([indep, common]).astype(np.int16)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=4,
             check_after_compress=False)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        descs = _descs(r)
        assert descs[4][1] and not descs[0][1]     # spatial engaged late
        assert np.array_equal(r[:], arr)
        assert np.array_equal(r[:, 5], arr[:, 5])
        assert np.array_equal(r[3000:13000, 2:7], arr[3000:13000, 2:7])
    finally:
        r.close()


def test_adapt_cli_flag(tmp_path_):
    from mtscomp_tpu.cli import mtscomp as cli_compress
    arr = drifting_signal(n_chunks=6)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    cli_compress([str(path), str(tmp_path_ / 'a.cbin'),
                  str(tmp_path_ / 'a.ch'), '-d', 'int16', '-s', '2000',
                  '-n', str(NC), '-a', 'ans', '--adapt', '3', '-nc'])
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        assert r.cmeta['transform_adapt'] == 3
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_adapt_desc_survives_generic_encode_path(tmp_path_):
    """The encode restart for dtypes the fused native prep declines
    (int32 here) must keep the bit5 descriptor: it was once dropped,
    writing adaptive chunks whose applied transform was unrecorded —
    silently corrupt whenever the window probe disagreed with the
    sidecar global (found by the lifecycle storm)."""
    rng = np.random.default_rng(5)
    half = 4 * 2000
    t = np.arange(half)
    noise = np.cumsum(rng.normal(0, 8, size=(half, NC)), axis=0)
    lfp = (800 * np.sin(2 * np.pi * 4 * t / 2000.0)[:, None]
           + np.cumsum(rng.normal(0, .6, size=(half, NC)), axis=0))
    arr = np.concatenate([noise, lfp]).astype(np.int32)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int32',
             algorithm='ans', quiet=True, transform_adapt=2,
             check_after_compress=False)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        descs = _descs(r)
        assert all(d is not None for d in descs)
        assert descs[0] != descs[-1]         # the probe really switched
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_adapt_multihost_parts_byte_identical(tmp_path_):
    """Window leaders are absolute chunk indices, so ranged part writes
    re-derive the same probes whatever the split: merged parts must be
    byte-identical to a one-shot adaptive compress."""
    from mtscomp_tpu.parallel.distributed import compress_multihost
    arr = drifting_signal(n_chunks=9)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'one.cbin', tmp_path_ / 'one.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=4,
             check_after_compress=False)
    compress_multihost(path, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                       sample_rate=SR, n_channels=NC, dtype='int16',
                       algorithm='ans', quiet=True, transform_adapt=4,
                       n_parts=3, check_after_compress=False)
    assert (tmp_path_ / 'm.cbin').read_bytes() \
        == (tmp_path_ / 'one.cbin').read_bytes()


def test_adapt_decompress_multi_falls_back(tmp_path_, monkeypatch, kernel_interpret):
    """Multi-probe decode of adaptive recordings: windows with mixed
    transforms cannot merge into one device batch — the documented
    per-reader fallback must decode exactly."""
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    arrs, readers = [], []
    try:
        for i in range(2):
            arr = drifting_signal(n_chunks=6, seed=10 + i)
            path = write_arr(tmp_path_ / ('p%d.bin' % i), arr)
            compress(path, tmp_path_ / ('p%d.cbin' % i),
                     tmp_path_ / ('p%d.ch' % i), sample_rate=SR,
                     n_channels=NC, dtype='int16', algorithm='ans',
                     quiet=True, transform_adapt=3,
                     check_after_compress=False)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('p%d.cbin' % i),
                                      tmp_path_ / ('p%d.ch' % i),
                                      quiet=True))
        outs = decompress_multi(readers)
        for out, arr in zip(outs, arrs):
            assert np.array_equal(out, arr)
    finally:
        for r in readers:
            r.close()


def test_adapt_bulk_device_runs_per_window(tmp_path_, monkeypatch, kernel_interpret):
    """decompress_to_array on an adaptive file: uniform-transform runs
    each ride the device batch decoder (one call per window run) —
    mixing windows must not dump the whole span to the host path."""
    from mtscomp_tpu.parallel import pipeline as pl
    arr = drifting_signal(n_chunks=8)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=4,
             check_after_compress=False)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    calls = []
    orig = pl.DeviceBatchDecoder.decode_batch

    def spy(self, parsed_list, ns, mesh=None):
        calls.append(len(parsed_list))
        return orig(self, parsed_list, ns, mesh=mesh)

    monkeypatch.setattr(pl.DeviceBatchDecoder, 'decode_batch', spy)
    try:
        assert _descs(r)[0] != _descs(r)[4]
        out = pl.decompress_to_array(r)
        assert np.array_equal(out, arr)
        assert calls == [4, 4]     # one device batch per uniform window
    finally:
        r.close()


def test_adapt_resume_non_aligned_stream(tmp_path_):
    """Resume of an adaptive ans_channel_segments=False stream: the
    codec's layout flag must be restored BEFORE the mid-window leader
    re-probe (probe sizes depend on it), keeping resumed bytes
    identical to an uninterrupted batch compress."""
    from mtscomp_tpu.stream import StreamWriter
    arr = drifting_signal(n_chunks=10)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, transform_adapt=3,
             ans_channel_segments=False, check_after_compress=False)
    w = StreamWriter(tmp_path_ / 'r.cbin', tmp_path_ / 'r.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', transform_adapt=3,
                     ans_channel_segments=False, live_sidecar=True)
    w.append(arr[:5 * 2000])           # crash mid-window (5 % 3 != 0)
    w._fb.close()
    w._closed = True
    w2 = StreamWriter.resume(tmp_path_ / 'r.cbin', tmp_path_ / 'r.ch')
    try:
        assert w2.codec.channel_aligned is False
        w2.append(arr[5 * 2000:])
    finally:
        w2.close()
    assert (tmp_path_ / 'r.cbin').read_bytes() \
        == (tmp_path_ / 'b.cbin').read_bytes()


def test_adapt_negative_window_rejected():
    from mtscomp_tpu import Writer
    from mtscomp_tpu.stream import StreamWriter
    with pytest.raises(ValueError, match='>= 0'):
        Writer(algorithm='ans', transform_adapt=-2)
    with pytest.raises(ValueError, match='>= 0'):
        StreamWriter('x.cbin', 'x.ch', sample_rate=SR, n_channels=NC,
                     dtype='int16', algorithm='ans', transform_adapt=-2)


def test_adapt_writer_reuse_probes_fresh_file(tmp_path_):
    """A reused Writer must probe the SECOND file's windows, not serve
    the first file's cached leader choices."""
    from mtscomp_tpu import Writer
    sig = drifting_signal(n_chunks=6)                 # 6 x 2000 samples
    lfp = sig[3 * 2000:]                              # LFP half only
    noise = sig[:3 * 2000]                            # noise half only
    p1 = write_arr(tmp_path_ / 'f1.bin', lfp)
    p2 = write_arr(tmp_path_ / 'f2.bin', noise)
    w = Writer(algorithm='ans', quiet=True, transform_adapt=2,
               check_after_compress=False)
    try:
        w.open(p1, sample_rate=SR, n_channels=NC, dtype='int16')
        w.write(tmp_path_ / 'f1.cbin', tmp_path_ / 'f1.ch')
        w.open(p2, sample_rate=SR, n_channels=NC, dtype='int16')
        w.write(tmp_path_ / 'f2.cbin', tmp_path_ / 'f2.ch')
    finally:
        w.close()
    r1 = decompress(tmp_path_ / 'f1.cbin', tmp_path_ / 'f1.ch', quiet=True)
    r2 = decompress(tmp_path_ / 'f2.cbin', tmp_path_ / 'f2.ch', quiet=True)
    try:
        d1, d2 = _descs(r1), _descs(r2)
        assert d1[2][0] == 2            # LFP window leaders pick order 2
        assert all(d[0] == 1 for d in d2), d2   # noise file: order 1
        assert np.array_equal(r2[:], noise)
    finally:
        r1.close()
        r2.close()


def test_adapt_device_encode_byte_identical(tmp_path_, monkeypatch, kernel_interpret):
    """Adaptive writers now ride the device encoder too: the batch
    splits into uniform-transform window runs, each device-encoded with
    the window's transform and the bit5 stamp — containers must be
    byte-identical to the host path's (runt runs take the host codec)."""
    arr = drifting_signal(n_chunks=10)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    for tag, dev in (('h', 'none'), ('d', 'cpu')):
        compress(path, tmp_path_ / (tag + '.cbin'),
                 tmp_path_ / (tag + '.ch'), sample_rate=SR,
                 n_channels=NC, dtype='int16', algorithm='ans',
                 quiet=True, transform_adapt=4, device=dev,
                 check_after_compress=False, n_threads=5)
    assert (tmp_path_ / 'h.cbin').read_bytes() \
        == (tmp_path_ / 'd.cbin').read_bytes()
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', quiet=True)
    try:
        assert all(d is not None for d in _descs(r))
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_adapt_device_encode_runt_windows(tmp_path_, monkeypatch, kernel_interpret):
    """1-chunk windows (every run below MIN_DEVICE_SUBBATCH) fall to
    the host codec per chunk, still byte-identical to device='none'."""
    arr = drifting_signal(n_chunks=6)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    for tag, dev in (('h', 'none'), ('d', 'cpu')):
        compress(path, tmp_path_ / (tag + '.cbin'),
                 tmp_path_ / (tag + '.ch'), sample_rate=SR,
                 n_channels=NC, dtype='int16', algorithm='ans',
                 quiet=True, transform_adapt=1, device=dev,
                 check_after_compress=False, n_threads=4)
    assert (tmp_path_ / 'h.cbin').read_bytes() \
        == (tmp_path_ / 'd.cbin').read_bytes()


def test_adapt_device_unsupported_dtype_falls_back(tmp_path_, monkeypatch, kernel_interpret):
    """int32 (itemsize > 2) never device-encodes: the adaptive device
    batcher must decline BEFORE probing window leaders and the host
    pool must produce the exact file."""
    arr = drifting_signal(n_chunks=6).astype(np.int32)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='int32',
             algorithm='ans', quiet=True, transform_adapt=3,
             device='cpu', check_after_compress=False)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
        assert all(d is not None for d in _descs(r))
    finally:
        r.close()


def test_adapt_decompress_multi_merges_uniform_windows(tmp_path_,
                                                       monkeypatch, kernel_interpret):
    """Adaptive probes whose requested range lies in ONE window (all
    chunks share a transform) must still merge into a single device
    batch — only mixed-transform ranges fall back per reader."""
    from mtscomp_tpu.parallel import pipeline as pl
    arrs, readers = [], []
    calls = []
    orig = pl.DeviceBatchDecoder.decode_batch

    def spy(self, parsed_list, ns, mesh=None):
        calls.append(len(parsed_list))
        return orig(self, parsed_list, ns, mesh=mesh)

    try:
        for i in range(2):
            arr = drifting_signal(n_chunks=8, seed=20 + i)
            path = write_arr(tmp_path_ / ('q%d.bin' % i), arr)
            compress(path, tmp_path_ / ('q%d.cbin' % i),
                     tmp_path_ / ('q%d.ch' % i), sample_rate=SR,
                     n_channels=NC, dtype='int16', algorithm='ans',
                     quiet=True, transform_adapt=4,
                     check_after_compress=False)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('q%d.cbin' % i),
                                      tmp_path_ / ('q%d.ch' % i),
                                      quiet=True))
        monkeypatch.setattr(pl.DeviceBatchDecoder, 'decode_batch', spy)
        outs = pl.decompress_multi(readers, first_chunk=0, last_chunk=3)
        for out, arr in zip(outs, arrs):
            assert np.array_equal(out, arr[:4 * 2000])
        assert calls == [8]       # ONE merged batch of both probes
    finally:
        for r in readers:
            r.close()
