"""Byte-exact float compression (v2 ``float_bitcast`` transform).

The reference's float round trips are only ``allclose`` (its in-dtype
float diff/cumsum is not an exact inverse — its own automatic check can
fail near zero crossings, mtscomp.py:880-886). Format v2 instead codes
the IEEE bit pattern as a same-width integer (modular diff == exact
inverse), recorded in the sidecar as ``float_bitcast``. These tests pin:

- bit-exact round trips for float16/32/64 incl. NaN/inf/-0.0, with the
  automatic post-compress check ON (it asserts bit equality);
- the sidecar flag is written for ans+float only;
- pre-flag (legacy v2) float files still decode float-domain;
- every read path (windows, bulk spans, tofile, chop) and the stream /
  transcode / merge surfaces preserve exactness and the flag.
"""

import json

import numpy as np
import pytest

from mtscomp_tpu.api import Reader, Writer, check, compress, decompress
from mtscomp_tpu.stream import StreamWriter
from mtscomp_tpu.transcode import transcode

from conftest import SAMPLE_RATE, write_arr


def bits(a):
    return np.asarray(a).view('u%d' % np.asarray(a).dtype.itemsize)


def bit_equal(a, b):
    return np.array_equal(bits(a), bits(b))


def make_float(dt, ns=6997, nc=7, specials=True):
    rng = np.random.default_rng(42)
    t = np.arange(ns)[:, None] / 500.0
    sig = (np.sin(t * (1 + np.arange(nc)[None] * 0.13))
           + 0.05 * rng.standard_normal((ns, nc))).astype(dt)
    if specials:
        sig[5, 0] = np.nan
        sig[6, 1] = np.inf
        sig[7, 2] = -np.inf
        sig[8, 3 % nc] = -0.0
    return sig


def compress_float(tmp, sig, name='data', **kw):
    path = write_arr(tmp / (name + '.bin'), sig)
    out, ch = tmp / (name + '.cbin'), tmp / (name + '.ch')
    kw.setdefault('algorithm', 'ans')
    kw.setdefault('quiet', True)
    ratio = compress(path, out, ch, sample_rate=SAMPLE_RATE,
                     n_channels=sig.shape[1], dtype=sig.dtype, **kw)
    return out, ch, ratio


@pytest.mark.parametrize('dt', ['float16', 'float32', 'float64'])
def test_roundtrip_bit_exact(tmp_path_, dt):
    sig = make_float(dt)
    # check_after_compress defaults on: for bitcast files it asserts
    # BIT equality (a float-domain writer would fail it on this data).
    out, ch, ratio = compress_float(tmp_path_, sig)
    assert 0 < ratio < 1.0
    cm = json.loads(ch.read_text())
    assert cm['float_bitcast'] is True
    r = decompress(out, ch)
    assert r.float_bitcast
    assert r.dtype == sig.dtype
    assert bit_equal(r[:], sig)
    # Window reads (cached single-chunk path) and scalar rows.
    assert bit_equal(r[100:200], sig[100:200])
    assert bit_equal(r[0], sig[0])
    assert bit_equal(r[-1], sig[-1])
    r.close()


def test_specials_survive(tmp_path_):
    sig = make_float('float32')
    out, ch, _ = compress_float(tmp_path_, sig)
    r = decompress(out, ch)
    back = r[:20]
    assert np.isnan(back[5, 0])
    assert back[6, 1] == np.inf and back[7, 2] == -np.inf
    assert back[8, 3] == 0.0 and np.signbit(back[8, 3])
    r.close()


def test_zlib_float_has_no_flag(tmp_path_):
    sig = np.cumsum(np.random.default_rng(0).standard_normal((3000, 5)),
                    axis=0)  # float64, smooth: passes the allclose check
    out, ch, _ = compress_float(tmp_path_, sig, algorithm='zlib')
    cm = json.loads(ch.read_text())
    assert 'float_bitcast' not in cm
    r = decompress(out, ch)
    assert not r.float_bitcast
    assert np.allclose(r[:], sig)
    r.close()


def test_int_has_no_flag(tmp_path_):
    sig = np.random.default_rng(0).integers(-100, 100, (3000, 5),
                                            dtype=np.int16)
    out, ch, _ = compress_float(tmp_path_, sig)
    assert 'float_bitcast' not in json.loads(ch.read_text())


def test_legacy_float_domain_still_decodes(tmp_path_):
    """v2 float files written before the flag existed decode float-domain."""
    sig = make_float('float32', specials=False)
    path = write_arr(tmp_path_ / 'data.bin', sig)
    w = Writer(algorithm='ans', quiet=True, check_after_compress=False)
    w.open(path, sample_rate=SAMPLE_RATE, n_channels=sig.shape[1],
           dtype=sig.dtype)
    # Re-create the pre-flag writer: float-domain transform, no flag.
    w.float_bitcast = False
    w.code_dtype = w.dtype
    out, ch = tmp_path_ / 'data.cbin', tmp_path_ / 'data.ch'
    w.write(out, ch)
    w.close()
    assert 'float_bitcast' not in json.loads(ch.read_text())
    r = decompress(out, ch)
    assert not r.float_bitcast
    # Float-domain transform: allclose, not bit-exact.
    assert np.allclose(r[:], sig, rtol=1e-3, atol=1e-4)
    r.close()


def test_bulk_span_and_tofile(tmp_path_):
    # >= 4 chunks and wider than the LRU: exercises _read_span_bulk's
    # in-place decode into integer views of the float span array.
    sig = make_float('float32', ns=12000, nc=11)
    out, ch, _ = compress_float(tmp_path_, sig, chunk_duration=0.5)
    r = Reader(quiet=True, cache_size=2, n_threads=2)
    r.open(out, ch)
    assert r.n_chunks >= 8
    assert bit_equal(r[:], sig)
    assert bit_equal(r[700:11500], sig[700:11500])
    raw_out = tmp_path_ / 'back.bin'
    r.tofile(raw_out)
    assert bit_equal(np.fromfile(raw_out, dtype=sig.dtype), sig.ravel())
    r.close()


def test_check_detects_float_corruption(tmp_path_):
    """The bit-exact check catches corruption that allclose would pass."""
    sig = make_float('float64', specials=False)
    out, ch, _ = compress_float(tmp_path_, sig)
    tweaked = sig.copy()
    tweaked[100, 0] = np.nextafter(tweaked[100, 0], np.inf)  # 1-ulp flip
    with pytest.raises(AssertionError):
        check(tweaked, out, ch)


def test_transform_variants(tmp_path_):
    sig = make_float('float32', nc=8)
    for kw in ({'do_time_diff': False},
               {'do_spatial_diff': True},
               {'chunk_order': 'C'},
               {'ans_table_mode': 'plane'}):
        out, ch, _ = compress_float(tmp_path_, sig,
                                    name='v%s' % list(kw)[0], **kw)
        r = decompress(out, ch)
        assert bit_equal(r[:], sig)
        r.close()


def test_stream_writer_and_resume(tmp_path_):
    sig = make_float('float32', ns=5000, nc=5)
    out, ch = tmp_path_ / 's.cbin', tmp_path_ / 's.ch'
    w = StreamWriter(out, ch, sample_rate=1000.0, n_channels=5,
                     dtype='float32', algorithm='ans', live_sidecar=True)
    w.append(sig[:2500])
    w._write_sidecar(streaming=True)   # publish the snapshot
    w._fb.flush()
    w._fb.close()
    w._closed = True                   # simulate a crash after 2 chunks
    w2 = StreamWriter.resume(out, ch)
    assert w2.float_bitcast
    w2.append(sig[w2.n_samples:])
    w2.close()
    cm = json.loads(ch.read_text())
    assert cm['float_bitcast'] is True
    r = decompress(out, ch)
    assert bit_equal(r[:], sig)
    r.close()
    # The stream is byte-identical to a batch compress of the same data.
    path = write_arr(tmp_path_ / 'batch.bin', sig)
    out2 = tmp_path_ / 'batch.cbin'
    compress(path, out2, tmp_path_ / 'batch.ch', sample_rate=1000.0,
             n_channels=5, dtype=sig.dtype, algorithm='ans',
             chunk_duration=1.0, quiet=True)
    assert out.read_bytes() == out2.read_bytes()


def test_transcode_gains_and_drops_flag(tmp_path_):
    sig = np.cumsum(np.random.default_rng(1).standard_normal((4000, 6)),
                    axis=0)  # float64, smooth
    # zlib (float-domain) -> ans: output gains the flag and round-trips
    # bit-exactly to what the zlib file DECODES to.
    zout, zch, _ = compress_float(tmp_path_, sig, name='z',
                                  algorithm='zlib')
    rz = decompress(zout, zch)
    decoded = rz[:]
    rz.close()
    aout, ach = tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch'
    transcode(zout, zch, out=aout, outmeta=ach, algorithm='ans',
              quiet=True)
    cm = json.loads(ach.read_text())
    assert cm['float_bitcast'] is True
    ra = decompress(aout, ach)
    assert bit_equal(ra[:], decoded)
    ra.close()
    # ans (bitcast) -> zlib: flag dropped, output decodes allclose.
    z2out, z2ch = tmp_path_ / 'z2.cbin', tmp_path_ / 'z2.ch'
    transcode(aout, ach, out=z2out, outmeta=z2ch, algorithm='zlib',
              quiet=True)
    assert 'float_bitcast' not in json.loads(z2ch.read_text())
    r2 = decompress(z2out, z2ch)
    assert np.allclose(r2[:], decoded, rtol=1e-5, atol=1e-8)
    r2.close()


def test_chop_keeps_flag(tmp_path_):
    sig = make_float('float32', ns=8000, nc=5)
    out, ch, _ = compress_float(tmp_path_, sig, chunk_duration=1.0)
    r = decompress(out, ch)
    r.chop(3, out=tmp_path_ / 'chopped.cbin')
    r.close()
    cm = json.loads((tmp_path_ / 'chopped.ch').read_text())
    assert cm['float_bitcast'] is True
    rc = decompress(tmp_path_ / 'chopped.cbin', tmp_path_ / 'chopped.ch')
    assert bit_equal(rc[:], sig[:rc.n_samples])
    rc.close()


def test_ratio_beats_float_domain(tmp_path_):
    """On smooth float data the bitcast transform compresses better than
    the float-domain diff (neighbors share sign/exponent bytes)."""
    sig = np.cumsum(np.random.default_rng(2).standard_normal((20000, 8)),
                    axis=0).astype(np.float32) * 0.01
    _, _, r_bitcast = compress_float(tmp_path_, sig, name='bc')
    path = write_arr(tmp_path_ / 'fd.bin', sig)
    w = Writer(algorithm='ans', quiet=True, check_after_compress=False)
    w.open(path, sample_rate=SAMPLE_RATE, n_channels=8, dtype=sig.dtype)
    w.float_bitcast = False
    w.code_dtype = w.dtype
    r_float = w.write(tmp_path_ / 'fd.cbin', tmp_path_ / 'fd.ch')
    w.close()
    assert r_bitcast < r_float


def test_device_decode_float(tmp_path_, monkeypatch, kernel_interpret):
    """Bitcast float files run the device decode pipeline (float16
    through the fused i16 kernels, float32 through the int32 variant)
    and the device chunk cache, bit-exactly."""
    from mtscomp_tpu.parallel.pipeline import (DeviceChunkCache,
                                               decompress_to_array)
    for dt in ('float16', 'float32'):
        sig = make_float(dt, ns=4000, nc=16)
        path = write_arr(tmp_path_ / ('d_%s.bin' % dt), sig)
        out, ch = tmp_path_ / ('d_%s.cbin' % dt), tmp_path_ / ('d_%s.ch' % dt)
        compress(path, out, ch, sample_rate=1000.0, n_channels=16,
                 dtype=dt, algorithm='ans', quiet=True, ans_seg_log2=12)
        r = decompress(out, ch, quiet=True, cache_size=2, device='cpu')
        try:
            full = decompress_to_array(r)
            assert full.dtype == sig.dtype
            assert bit_equal(full, sig)
            cache = DeviceChunkCache(r)
            for i0, i1 in [(0, 500), (1500, 2500), (100, 3200)]:
                w = cache.read_window(i0, i1)
                assert w.dtype == sig.dtype
                assert bit_equal(w, sig[i0:i1])
            assert bit_equal(r[700:2300], sig[700:2300])
        finally:
            r.close()


def test_device_encode_float16(tmp_path_):
    """float16 writers run the device batch encoder (i16 coding view)
    and emit containers byte-identical to the host codec."""
    sig = make_float('float16', ns=4000, nc=16, specials=False)
    path = write_arr(tmp_path_ / 'e.bin', sig)
    host_out, host_ch = tmp_path_ / 'h.cbin', tmp_path_ / 'h.ch'
    compress(path, host_out, host_ch, sample_rate=1000.0, n_channels=16,
             dtype='float16', algorithm='ans', quiet=True, device='none')
    dev_out, dev_ch = tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch'
    compress(path, dev_out, dev_ch, sample_rate=1000.0, n_channels=16,
             dtype='float16', algorithm='ans', quiet=True, device='cpu')
    assert host_out.read_bytes() == dev_out.read_bytes()
    r = decompress(dev_out, dev_ch)
    assert bit_equal(r[:], sig)
    r.close()
