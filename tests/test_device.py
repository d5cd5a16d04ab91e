"""Device (JAX) paths: grouped rANS decode, delta ops, full pipeline.

Runs on the virtual CPU backend (conftest pins jax to cpu with 8 virtual
devices); the same code paths run on the GPU, where the decode kernel
is compiled instead of interpreted.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu import compress, decompress  # noqa: E402
from mtscomp_tpu.models import rans  # noqa: E402
from mtscomp_tpu.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu.ops.device_rans import decode_groups_host  # noqa: E402
from mtscomp_tpu.parallel.pipeline import decompress_to_array  # noqa: E402

from conftest import write_arr, to_int16, make_signal


def test_jax_decode_groups_bit_exact():
    rng = np.random.default_rng(0)
    groups, tables = [], []
    for gi in range(5):
        R = int(rng.integers(1, 9))
        rows, freq_rows, segs = [], [], []
        for r in range(R):
            n = int(rng.integers(1, 4000))
            p = rng.dirichlet(np.full(256, float(rng.choice([0.05, 1.0]))))
            syms = rng.choice(256, size=n, p=p).astype(np.uint8)
            counts = np.bincount(syms, minlength=256)
            f = rans.quantize_freqs(counts)
            if f is None:
                f = rans.quantize_freqs(
                    np.array([1, 1] + [0] * 254, dtype=np.int64))
            rows.append(syms)
            freq_rows.append(f)
            segs.append((r, 0, n))
        states, words = rans.rans_encode_group(rows, np.stack(freq_rows))
        groups.append({'segments': segs, 'states': states, 'words': words,
                       'rows_truth': rows, 'tables': freq_rows})

    def freq_of_segment(i, p, start):
        return groups[i]['tables'][p]

    decoded = decode_groups_host(groups, freq_of_segment)
    for g, rows_dec in zip(groups, decoded):
        for truth, got in zip(g['rows_truth'], rows_dec):
            assert np.array_equal(truth, got)


@pytest.mark.parametrize('shape', [(3, 1000, 100), (1, 256, 128),
                                   (2, 777, 19)])
def test_device_delta_exact(shape):
    rng = np.random.default_rng(1)
    x = rng.integers(-32768, 32768, size=shape, dtype=np.int16)
    d = np.asarray(dd.diff_time_jnp(x))
    ref = np.concatenate([x[:, :1], np.diff(x, axis=1)], axis=1)
    assert np.array_equal(d, ref)
    assert np.array_equal(np.asarray(dd.cumsum_time_jnp(jnp.asarray(d))), x)
    # Channel-major input transposed inside the jit: the fused
    # finalize's form of the same scan.
    ct = jnp.asarray(np.ascontiguousarray(np.transpose(d, (0, 2, 1))))
    out = jax.jit(lambda a: dd.cumsum_time_jnp(
        jnp.transpose(a, (0, 2, 1))))(ct)
    assert np.array_equal(np.asarray(out), x)


def test_device_zigzag_matches_host():
    rng = np.random.default_rng(2)
    for dt in ('int16', 'uint16', 'int8', 'int32'):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, size=500, endpoint=True,
                         dtype=dt)
        z = rans.zigzag_encode(v)
        assert np.array_equal(np.asarray(dd.zigzag_encode_jnp(jnp.asarray(v))), z)
        assert np.array_equal(
            np.asarray(dd.zigzag_decode_jnp(jnp.asarray(z), np.dtype(dt))), v)


@pytest.mark.parametrize('nc', [19, 128])
def test_pipeline_full_roundtrip(tmp_path_, nc):
    arr = to_int16(make_signal('colored', ns=10000, nc=nc))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=3000.0, n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        out = decompress_to_array(r)
        assert out.shape == arr.shape
        assert np.array_equal(out, arr)
        out2 = decompress_to_array(r, 1, 2)
        assert np.array_equal(out2, arr[3000:9000])
    finally:
        r.close()


def test_pipeline_large_alphabet_interpret(tmp_path_, monkeypatch, kernel_interpret):
    """Alphabet > 128 exercises the two-row dense lookups in the kernel."""
    rng = np.random.default_rng(11)
    # High-entropy diffs: zigzag codes cover far more than 128 symbols
    # (sigma 30 also makes the HIGH plane RANS-coded: two coded planes).
    arr = np.cumsum(rng.normal(0, 30, size=(2 * 2000, 24)),
                    axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2000.0, n_channels=24, dtype='int16',
             algorithm='ans', quiet=True, check_after_compress=False)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        from mtscomp_tpu.parallel.pipeline import _read_payload
        parsed = r.codec.parse(_read_payload(r, 0))
        freqs = parsed['planes'][0]['freqs']
        assert np.count_nonzero(freqs) > 128
        out = decompress_to_array(r)
        assert np.array_equal(out, arr)
    finally:
        r.close()


def test_pipeline_spatial_diff(tmp_path_):
    arr = to_int16(make_signal('white_sine', ns=5000, nc=16))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2000.0, n_channels=16, dtype='int16',
             algorithm='ans', quiet=True, do_spatial_diff=True,
             ans_seg_log2=12)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        assert np.array_equal(decompress_to_array(r), arr)
    finally:
        r.close()


def test_pipeline_order_c(tmp_path_):
    arr = to_int16(make_signal('randn', ns=4000, nc=8))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2000.0, n_channels=8, dtype='int16',
             algorithm='ans', quiet=True, chunk_order='C', ans_seg_log2=12)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        assert np.array_equal(decompress_to_array(r), arr)
    finally:
        r.close()


def test_pipeline_sharded_mesh(tmp_path_):
    """Chunk batch sharded over the 8-device virtual mesh (shard_map)."""
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload)
    arr = to_int16(make_signal('colored', ns=8 * 2000, nc=16))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2000.0, n_channels=16, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        assert r.n_chunks == 8
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(8)]
        dec = DeviceBatchDecoder(r)
        assert dec.supported(parsed, 2000)
        mesh = chunk_mesh(jax.devices('cpu')[:8])
        out = dec.decode_batch(parsed, 2000, mesh=mesh)
        assert np.array_equal(out.reshape(-1, 16), arr)
    finally:
        r.close()


def test_benchmark_harness_smoke(tmp_path_):
    from mtscomp_tpu.benchmarks import mtscomp_perf, format_report
    from mtscomp_tpu.benchmarks.harness import make_dataset
    arr, sr = make_dataset('small_64', duration=0.3)
    rows = []
    for algorithm in ('zlib', 'ans'):
        row = mtscomp_perf(arr, sr, algorithm=algorithm, device=False,
                           read_windows=3)
        assert row['ratio'] > 1.5
        rows.append(row)
    report = format_report(rows)
    assert 'ratio' in report and 'zlib' in report


def _cover_table(syms):
    """Frequency table guaranteed to cover ``syms`` (>=2 present)."""
    counts = np.bincount(syms, minlength=256)
    f = rans.quantize_freqs(counts)
    if f is None:
        counts[(int(syms[0]) + 1) % 256] += 1
        f = rans.quantize_freqs(counts)
    return f


def test_device_histogram_exact():
    """The byte histogram matches np.bincount exactly."""
    from mtscomp_tpu.ops.device_hist import histogram256, BLOCK
    rng = np.random.default_rng(0)
    cases = [
        rng.integers(0, 256, size=(3, 1000), dtype=np.uint8),
        rng.integers(0, 256, size=(2, BLOCK + 777), dtype=np.uint8),
        np.zeros((1, 513), dtype=np.uint8),            # all in bin 0
        np.full((1, 64), 255, dtype=np.uint8),         # all in bin 255
        (rng.integers(0, 3, size=(4, 4096)) * 17).astype(np.uint8),
    ]
    for v in cases:
        ref = np.stack([np.bincount(row, minlength=256) for row in v])
        got = np.asarray(histogram256(jnp.asarray(v)))
        assert np.array_equal(got, ref), v.shape


def test_device_encode_bit_identical():
    from mtscomp_tpu.ops.device_rans import encode_groups, compact_words
    rng = np.random.default_rng(0)
    R = rans.GROUP_ROWS
    S = 16
    N = 3
    symbols = np.zeros((N, R, S * 128), np.uint8)
    freqs = np.zeros((N, R, 256), np.int32)
    counts = np.zeros((N, R), np.int32)
    refs = []
    for g in range(N):
        rows, tables = [], []
        r_use = [R, R, 5][g]
        for r in range(r_use):
            n = int(rng.integers(1, S * 128 + 1)) if r % 3 else S * 128
            p = rng.dirichlet(np.full(256, float(rng.choice([0.05, 1.0]))))
            syms = rng.choice(256, size=n, p=p).astype(np.uint8)
            f = _cover_table(syms)
            rows.append(syms)
            tables.append(f)
            symbols[g, r, :n] = syms
            freqs[g, r] = f
            counts[g, r] = n
        for r in range(r_use, R):
            freqs[g, r] = rans.quantize_freqs(
                np.array([1, 1] + [0] * 254, dtype=np.int64))
        st, wd = rans.rans_encode_group(rows, np.stack(tables))
        refs.append((st, wd, r_use))

    enc_pk, enc_rcp = rans.encoder_tables(freqs)
    states, words_dense, emit = encode_groups(
        jnp.asarray(symbols), jnp.asarray(enc_pk), jnp.asarray(enc_rcp),
        jnp.asarray(counts), n_steps=S)
    wmax = max(1, int(np.asarray(emit).sum(axis=(0, 2)).max()))
    streams, n_words = compact_words(words_dense, emit, wmax)
    states, streams = np.asarray(states), np.asarray(streams)
    n_words = np.asarray(n_words)
    for g, (st_ref, wd_ref, r_use) in enumerate(refs):
        assert np.array_equal(states[g, :r_use], st_ref[:r_use])
        assert n_words[g] == wd_ref.size
        assert np.array_equal(streams[g, :wd_ref.size], wd_ref)


@pytest.mark.parametrize('aligned,extra', [
    (False, {}), (True, {}),
    (True, {'do_spatial_diff': True}),
    (False, {'chunk_order': 'C'}),
    (True, {'dtype_name': 'uint16'}),
    # Ragged-tail segment split (flags bit6): 129 ch at seg_log2=12 ->
    # tsplit=8; pins the device encoder's non-uniform row gather and
    # bit6 header emission byte-identical to the host codec on the
    # CPU suite (the storm re-proves it on silicon).
    (True, {'nc': 129}),
])
def test_device_encode_batch_byte_identical(tmp_path_, aligned, extra):
    """Device-encoded containers match the host codec byte for byte."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    extra = dict(extra)
    dtype_name = extra.pop('dtype_name', 'int16')
    nc = extra.pop('nc', 24)
    if not aligned:
        # Segment clustering (the default) requires the aligned layout
        # and correctly declines the device batch otherwise; the
        # non-aligned cells pin plane tables to test the device path.
        extra.setdefault('ans_table_mode', 'plane')
    arr = to_int16(make_signal('colored', ns=4 * 3000, nc=nc))
    arr = arr.astype(np.dtype(dtype_name))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    w = Writer(algorithm='ans', quiet=True, ans_seg_log2=12,
               ans_channel_segments=aligned, **extra)
    w.open(path, sample_rate=3000.0, n_channels=nc, dtype=dtype_name)
    chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
    enc = DeviceBatchEncoder(w)
    assert enc.supported(chunks[0].shape[0])
    payloads = enc.encode_batch(np.stack(chunks))
    assert payloads is not None
    for chunk, payload in zip(chunks, payloads):
        host = w.codec.encode(w._transform_chunk(chunk),
                              order=w.chunk_order)
        assert payload == host
    w.close()


def _hetero_arr(ns=4 * 3000, nc=24, seed=5):
    rng = np.random.default_rng(seed)
    stds = np.logspace(0.0, 1.6, nc)
    return np.clip(np.cumsum(rng.normal(0, 1, (ns, nc)) * stds, axis=0),
                   -30000, 30000).astype(np.int16)


@pytest.mark.parametrize('decoder', ['scan', 'kernel'])
def test_device_encode_segment_tables_byte_identical(
        tmp_path_, monkeypatch, decoder):
    """Device encode with table_mode='segment' (per-channel histograms
    on device, clustering on host) stays byte-identical to the host
    codec and actually emits bit4 containers on heterogeneous data; a
    device-encoded file decodes back exactly through either device
    decoder (the GPU kernel in interpret mode)."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel import pipeline
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    arr = _hetero_arr()
    path = write_arr(tmp_path_ / 'd.bin', arr)
    w = Writer(algorithm='ans', quiet=True, ans_seg_log2=12,
               ans_table_mode='segment')
    w.open(path, sample_rate=3000.0, n_channels=24, dtype='int16')
    chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
    enc = DeviceBatchEncoder(w)
    assert enc.supported(chunks[0].shape[0])
    payloads = enc.encode_batch(np.stack(chunks))
    assert payloads is not None
    saw_multitable = False
    for chunk, payload in zip(chunks, payloads):
        host = w.codec.encode(w._transform_chunk(chunk),
                              order=w.chunk_order)
        assert payload == host
        parsed = w.codec.parse(payload)
        saw_multitable |= parsed['planes'][0].get('tidx') is not None
    assert saw_multitable
    w.close()
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=3000.0, n_channels=24, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12,
             ans_table_mode='segment', device='cpu',
             check_after_compress=False)
    monkeypatch.setattr(pipeline, 'DECODER', decoder)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', quiet=True)
    try:
        assert np.array_equal(decompress_to_array(r), arr)
    finally:
        r.close()


def test_device_encode_segment_tables_host_fallbacks(tmp_path_):
    """Non-aligned layouts decline device encode under segment mode
    (the host codec handles generic-segment clustering)."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    arr = _hetero_arr()
    path = write_arr(tmp_path_ / 'd.bin', arr)
    w = Writer(algorithm='ans', quiet=True, ans_seg_log2=12,
               ans_table_mode='segment', ans_channel_segments=False)
    w.open(path, sample_rate=3000.0, n_channels=24, dtype='int16')
    chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
    enc = DeviceBatchEncoder(w)
    assert enc.encode_batch(np.stack(chunks)) is None
    w.close()


def test_device_encode_segment_tables_mesh(tmp_path_):
    """Segment tables through the shard_map-sharded encode scan."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    arr = _hetero_arr(ns=4 * 2000, nc=32)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    w = Writer(algorithm='ans', quiet=True, ans_seg_log2=11,
               ans_table_mode='segment')
    w.open(path, sample_rate=2000.0, n_channels=32, dtype='int16')
    chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
    enc = DeviceBatchEncoder(w)
    mesh = chunk_mesh(jax.devices('cpu')[:8])
    payloads = enc.encode_batch(np.stack(chunks), mesh=mesh)
    assert payloads is not None
    for chunk, payload in zip(chunks, payloads):
        host = w.codec.encode(w._transform_chunk(chunk),
                              order=w.chunk_order)
        assert payload == host
    w.close()


def test_device_encode_sharded_mesh(tmp_path_):
    """Encode scan sharded over the 8-device virtual mesh (shard_map)."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    arr = to_int16(make_signal('colored', ns=4 * 2000, nc=32))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    w = Writer(algorithm='ans', quiet=True, ans_seg_log2=11)
    w.open(path, sample_rate=2000.0, n_channels=32, dtype='int16')
    chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
    enc = DeviceBatchEncoder(w)
    mesh = chunk_mesh(jax.devices('cpu')[:8])
    payloads = enc.encode_batch(np.stack(chunks), mesh=mesh)
    assert payloads is not None
    for chunk, payload in zip(chunks, payloads):
        host = w.codec.encode(w._transform_chunk(chunk),
                              order=w.chunk_order)
        assert payload == host
    w.close()


@pytest.mark.parametrize('aligned', [False, True])
def test_device_encode_end_to_end(tmp_path_, aligned):
    """compress() with the device encoder forced; verify + cross-decode."""
    from mtscomp_tpu import compress, decompress
    arr = to_int16(make_signal('white_sine', ns=6 * 2500, nc=16))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2500.0, n_channels=16, dtype='int16',
             algorithm='ans', quiet=True, device='cpu', ans_seg_log2=12,
             ans_channel_segments=aligned)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        assert np.array_equal(r[:], arr)          # host decode
        assert np.array_equal(decompress_to_array(r), arr)  # device decode
    finally:
        r.close()


@pytest.mark.parametrize('dtype', [np.int8, np.uint8, np.uint16,
                                   np.int32, np.uint32])
def test_device_decode_narrow_dtypes(tmp_path_, dtype, monkeypatch, kernel_interpret):
    """Every integer width decodes exactly through the GPU decode
    kernel (interpret mode) and the in-dtype wrapping scans."""
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.normal(0, 3, size=(3 * 2000, 16)), axis=0)
    arr = np.mod(np.round(walk), np.iinfo(dtype).max + 1 -
                 np.iinfo(dtype).min).astype(np.int64)
    arr = (arr + np.iinfo(dtype).min).astype(dtype)
    path = write_arr(tmp_path_ / 'n.bin', arr)
    compress(path, tmp_path_ / 'n.cbin', tmp_path_ / 'n.ch',
             sample_rate=2000.0, n_channels=16, dtype=np.dtype(dtype).name,
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 'n.cbin', tmp_path_ / 'n.ch', quiet=True)
    try:
        assert np.array_equal(decompress_to_array(r), arr)
    finally:
        r.close()


@pytest.mark.parametrize('dtype', ['int64', 'uint64', 'float64'])
def test_device_paths_wide_dtypes_exact(tmp_path_, dtype, monkeypatch, kernel_interpret):
    """8-byte dtypes: the device decoder must DECLINE them (JAX's
    default x64-disabled mode silently truncates a uint64 plane
    accumulator to uint32, OR-shifting planes 4-7 away — wrong values
    with the wrong dtype, and no payload guard fires; confirmed round
    2), so every forced device path falls back to the host codec and
    still returns byte-exact data with the right dtype. Values exceed
    2**32 so upper-plane loss cannot hide."""
    rng = np.random.default_rng(11)
    ns, nc = 3 * 1000, 12
    base = np.int64(3) << 40
    walk = np.cumsum(rng.integers(-1000, 1000, size=(ns, nc),
                                  dtype=np.int64), axis=0) + base
    if dtype == 'int64':
        arr = walk
    elif dtype == 'uint64':
        arr = walk.astype(np.uint64) + (np.uint64(1) << np.uint64(63))
    else:
        arr = walk.astype(np.float64) * 1.5
        arr[0, 0] = np.nan
        arr[0, 1] = -np.inf                 # bitcast path: bit-exact
    path = write_arr(tmp_path_ / 'wide.bin', arr)
    compress(path, tmp_path_ / 'wide.cbin', tmp_path_ / 'wide.ch',
             sample_rate=1000.0, n_channels=nc, dtype=dtype,
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 'wide.cbin', tmp_path_ / 'wide.ch',
                   quiet=True, device='cpu')
    try:
        from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                                   _read_payload)
        parsed = [r.codec.parse(_read_payload(r, 0))]
        ns0 = r.chunk_bounds[1] - r.chunk_bounds[0]
        assert not DeviceBatchDecoder(r).supported(parsed, ns0)
        # Forced-device bulk decode: host fallback, byte-exact.
        got = decompress_to_array(r)
        assert got.dtype == arr.dtype
        assert got.tobytes() == arr.tobytes()
        got = r.to_array()
        assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
        # Forced-device window reads: DeviceChunkCache declines, the
        # host path serves them.
        for i0, i1 in [(0, 100), (900, 1100), (2950, 3000)]:
            win = r[i0:i1]
            assert win.dtype == arr.dtype
            assert win.tobytes() == arr[i0:i1].tobytes()
        assert r[50:60, 3:9].tobytes() == arr[50:60, 3:9].tobytes()
    finally:
        r.close()


def test_wide_dtypes_auto_routing_declines_before_jax(tmp_path_,
                                                      monkeypatch):
    """device='auto' on an 8-byte-dtype file must decide 'host' without
    initializing a backend or probing the link."""
    from mtscomp_tpu.parallel import pipeline
    rng = np.random.default_rng(12)
    arr = (rng.integers(-1000, 1000, size=(2000, 8), dtype=np.int64)
           + (np.int64(5) << 40))
    path = write_arr(tmp_path_ / 'a.bin', arr)
    compress(path, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=1000.0, n_channels=8, dtype='int64',
             algorithm='ans', quiet=True, check_after_compress=False)

    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("link_profile probed for a 64-bit file")

    monkeypatch.setattr(pipeline, 'link_profile', boom)
    # Defeat the small-file gate so the dtype gate is what's tested.
    import mtscomp_tpu.api as api_mod
    monkeypatch.setattr(api_mod, 'AUTO_DEVICE_MIN_BYTES', 0)
    r = decompress(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch', quiet=True,
                   device='auto')
    try:
        assert not r._use_device()
        assert not r._use_device(window=(0, 100))
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()


def test_multi_probe_mesh(tmp_path_):
    """BASELINE config 4: multiple probes decoded chunk-parallel on the
    virtual mesh in one sharded device call."""
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    readers, truths = [], []
    for probe in range(4):
        arr = to_int16(make_signal('colored', ns=2 * 2000, nc=16)) + probe
        path = write_arr(tmp_path_ / f'p{probe}.bin', arr)
        compress(path, tmp_path_ / f'p{probe}.cbin',
                 tmp_path_ / f'p{probe}.ch', sample_rate=2000.0,
                 n_channels=16, dtype='int16', algorithm='ans',
                 quiet=True, ans_seg_log2=12)
        readers.append(decompress(tmp_path_ / f'p{probe}.cbin',
                                  tmp_path_ / f'p{probe}.ch'))
        truths.append(arr)
    try:
        mesh = chunk_mesh(jax.devices('cpu')[:8])
        outs = decompress_multi(readers, mesh=mesh)
        for got, want in zip(outs, truths):
            assert np.array_equal(got, want)
    finally:
        for r in readers:
            r.close()


@pytest.mark.parametrize('dtype', ['int16', 'uint16'])
def test_fuse8_decode_interpret(tmp_path_, monkeypatch, dtype, kernel_interpret):
    """The kernel's u8 rows combined, zigzag-decoded, transposed and
    scanned in one jitted decode (interpret mode).

    uint16 covers the 16-bit path of the reference's canonical
    Neuropixels dataset (uint16).
    """
    arr = to_int16(make_signal('colored', ns=4 * 300, nc=40))
    arr = arr.astype(np.dtype(dtype))       # bit pattern reinterpretation
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=300.0, n_channels=40, dtype=dtype,
             algorithm='ans', quiet=True, check_after_compress=False)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch')
    try:
        from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                                   _read_payload,
                                                   _build_decode_fn)
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(4)]
        assert parsed[0]['aligned']
        dec = DeviceBatchDecoder(r)
        assert dec.supported(parsed, 300)
        _build_decode_fn.cache_clear()
        out = dec.decode_batch(parsed, 300)
        assert np.array_equal(out.reshape(-1, 40), arr)
    finally:
        r.close()


def test_device_chunk_cache_windows(tmp_path_, monkeypatch, kernel_interpret):
    """Random-access windows through the device-resident chunk cache
    (decode + slice on device, LRU eviction, multi-chunk stitching)."""
    rng = np.random.default_rng(21)
    arr = np.cumsum(rng.normal(0, 5, size=(4 * 1000, 16)),
                    axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'w.bin', arr)
    compress(path, tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch',
             sample_rate=1000.0, n_channels=16, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch', quiet=True,
                   cache_size=2, device='cpu')
    try:
        from mtscomp_tpu.parallel.pipeline import DeviceChunkCache
        cache = DeviceChunkCache(r)
        for i0, i1 in [(0, 500), (1500, 2500), (3900, 4000), (100, 3200),
                       (0, 4000)]:
            assert np.array_equal(cache.read_window(i0, i1), arr[i0:i1])
        # Reader.__getitem__ routes through the device window too.
        assert np.array_equal(r[700:2300], arr[700:2300])
        assert np.array_equal(r[50:60, 3:9], arr[50:60, 3:9])
    finally:
        r.close()


def test_device_storm_fixed_geometry(tmp_path_):
    """One geometry (compiles reused), many data shapes: the device
    decode pipeline and device encoder must stay byte-exact across
    data-dependent plane-mode combinations (RANS/RANS, RANS/CONST,
    near-RAW, constant chunks, heterogeneous channels)."""
    from mtscomp_tpu import Writer, compress, decompress
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchEncoder,
                                               decompress_to_array)
    rng = np.random.default_rng(77)
    ns, nc = 3 * 1500, 24
    kinds = {
        'smooth': np.cumsum(rng.normal(0, 6, (ns, nc)), axis=0),
        'tiny': rng.integers(-1, 2, (ns, nc)),
        'const': np.full((ns, nc), 7),
        'wide': rng.integers(-30000, 30000, (ns, nc)),
        'hetero': np.cumsum(rng.normal(0, 1, (ns, nc))
                            * np.logspace(0, 1.6, nc), axis=0),
    }
    for name, data in kinds.items():
        arr = np.clip(data, -30000, 30000).astype(np.int16)
        raw = tmp_path_ / ('%s.bin' % name)
        write_arr(raw, arr)
        compress(raw, tmp_path_ / ('%s.cbin' % name),
                 tmp_path_ / ('%s.ch' % name), sample_rate=1500.0,
                 n_channels=nc, dtype='int16', algorithm='ans',
                 quiet=True, check_after_compress=False)
        r = decompress(tmp_path_ / ('%s.cbin' % name),
                       tmp_path_ / ('%s.ch' % name), quiet=True)
        try:
            got = decompress_to_array(r)
            assert np.array_equal(got, arr), name
        finally:
            r.close()
        # Device encode identity on the same data.
        w = Writer(algorithm='ans', quiet=True)
        w.open(raw, sample_rate=1500.0, n_channels=nc, dtype='int16')
        chunks = [np.asarray(w.get_chunk(i)) for i in range(w.n_chunks)]
        enc = DeviceBatchEncoder(w)
        payloads = enc.encode_batch(np.stack(chunks))
        if payloads is not None:
            for chunk, payload in zip(chunks, payloads):
                host = w.codec.encode(w._transform_chunk(chunk),
                                      order=w.chunk_order)
                assert payload == host, name
        w.close()


def test_decompress_to_array_span_destinations(tmp_path_):
    """Device bulk reads decode into one span-wide destination: out=
    views are honored, the partial-tail file round-trips identically,
    read-only consumers get the zero-extra-copy fast path, and chunk
    groups the device declines land in the same span via the host
    codec."""
    from mtscomp_tpu.parallel.pipeline import decompress_to_array
    rng = np.random.default_rng(5)
    ns, nc = 3 * 1000 + 400, 16          # partial tail chunk
    arr = np.cumsum(rng.normal(0, 5, size=(ns, nc)), axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 's.bin', arr)
    compress(path, tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
             sample_rate=1000.0, n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12)
    r = decompress(tmp_path_ / 's.cbin', tmp_path_ / 's.ch', quiet=True)
    try:
        got = decompress_to_array(r)
        assert got.flags.writeable
        assert np.array_equal(got, arr)
        # Caller-provided span destination.
        dst = np.empty_like(arr)
        ret = decompress_to_array(r, out=dst)
        assert ret is dst and np.array_equal(dst, arr)
        # Read-only fast path over the uniform prefix (one group).
        pre = decompress_to_array(r, 0, r.n_chunks - 2, writable=False)
        assert np.array_equal(pre, arr[:r.chunk_bounds[r.n_chunks - 1]])
        # Sub-ranges with explicit destinations.
        n1 = r.chunk_bounds[2] - r.chunk_bounds[1]
        d1 = np.empty((n1, nc), np.int16)
        decompress_to_array(r, 1, 1, out=d1)
        assert np.array_equal(d1, arr[r.chunk_bounds[1]:r.chunk_bounds[2]])
    finally:
        r.close()
    # Host-fallback groups (mixed plane modes within one batch) write
    # into the same span: chunk 0 constant (CONST planes), chunk 1
    # noisy (RANS) -> the 2-chunk group fails the uniformity check.
    arr2 = np.concatenate([
        np.full((1000, nc), 3, np.int16),
        rng.integers(-3000, 3000, size=(1000, nc)).astype(np.int16)])
    path2 = write_arr(tmp_path_ / 'm.bin', arr2)
    compress(path2, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
             sample_rate=1000.0, n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True)
    r2 = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                                   _read_payload)
        parsed = [r2.codec.parse(_read_payload(r2, i)) for i in range(2)]
        if not DeviceBatchDecoder(r2).supported(parsed, 1000):
            got2 = decompress_to_array(r2)
            assert np.array_equal(got2, arr2)
            dst2 = np.empty_like(arr2)
            assert decompress_to_array(r2, out=dst2) is dst2
            assert np.array_equal(dst2, arr2)
    finally:
        r2.close()


def test_mixed_mode_encode_small_subbatches_use_host(tmp_path_):
    """A pathological batch whose chunks all decide different plane
    modes must not compile one device signature per chunk: sub-batches
    below MIN_DEVICE_SUBBATCH go through the host codec (byte-identical
    containers either way). Asserted via a transform-builder probe —
    only the top-level batch signature may be built."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel import pipeline as pl
    rng = np.random.default_rng(9)
    ns, nc = 1000, 16
    info = np.iinfo(np.int16)
    blocks = [
        np.cumsum(rng.normal(0, 6, (ns, nc)), axis=0),        # RANS/RANS
        np.full((ns, nc), 5.0),                               # CONST
        rng.integers(info.min, info.max, (ns, nc)),           # near-RAW
        rng.integers(-1, 2, (ns, nc)),                        # tiny alpha
    ]
    arr = np.concatenate([np.clip(b, info.min, info.max) for b in blocks]
                         ).astype(np.int16)
    path = write_arr(tmp_path_ / 'p.bin', arr)
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=float(ns), n_channels=nc, dtype='int16')
        chunks = np.stack([np.asarray(w.get_chunk(i))
                           for i in range(w.n_chunks)])
        enc = pl.DeviceBatchEncoder(w)
        built = []
        orig = pl._build_transform_fn

        def probe(B, *a, **k):
            built.append(B)
            return orig(B, *a, **k)

        try:
            pl._build_transform_fn = probe
            payloads = enc.encode_batch(chunks)
        finally:
            pl._build_transform_fn = orig
        # The chunks genuinely disagree on modes (else the scenario
        # under test did not materialize).
        assert payloads is not None
        rows = {tuple(w.codec.parse(p)['modes']) for p in payloads}
        assert len(rows) >= 2, rows
        assert all(B == len(chunks) for B in built), built
        for i, p in enumerate(payloads):
            host = w.codec.encode(w._transform_chunk(chunks[i]),
                                  order=w.chunk_order)
            assert p == host, i
    finally:
        w.close()


def test_decompress_multi_mismatched_probes_fall_back(tmp_path_):
    """Probes differing in diff flags or dtype must not merge into one
    device batch (they would decode with probe 0's metadata)."""
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    arrs, readers = [], []
    try:
        for i, extra in enumerate([{}, {'do_time_diff': False}]):
            arr = to_int16(make_signal('colored', ns=2 * 2000, nc=12))
            path = write_arr(tmp_path_ / ('p%d.bin' % i), arr)
            compress(path, tmp_path_ / ('p%d.cbin' % i),
                     tmp_path_ / ('p%d.ch' % i), sample_rate=2000.0,
                     n_channels=12, dtype='int16', algorithm='ans',
                     quiet=True, ans_seg_log2=12, **extra)
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


def test_decompress_multi_mixed_orders_fall_back(tmp_path_):
    """Round-3 silent-corruption regression: same-geometry probes whose
    SIDECARS differ in time_diff_order (a v2 extension invisible to
    supported() — it is not in the chunk payloads) merged into one
    batch and the order-2 probe decoded to wrong samples with no error.
    The decode-identity check must fall back; both must round-trip
    exactly. With time_diff_order='auto' the shipped default, probes of
    one session genuinely resolve differently."""
    import numpy as _np
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    t = _np.arange(2 * 2000) / 2000.0
    smooth = (_np.sin(2 * _np.pi * 4.0 * t)[:, None] * 11000.
              + _np.random.RandomState(0).normal(0, 15., (2 * 2000, 12))
              ).astype(_np.int16)
    arrs, readers = [], []
    try:
        for i, order in enumerate([1, 2]):
            arr = smooth + i
            path = write_arr(tmp_path_ / ('q%d.bin' % i), arr)
            compress(path, tmp_path_ / ('q%d.cbin' % i),
                     tmp_path_ / ('q%d.ch' % i), sample_rate=2000.0,
                     n_channels=12, dtype='int16', algorithm='ans',
                     quiet=True, ans_seg_log2=12, time_diff_order=order)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('q%d.cbin' % i),
                                      tmp_path_ / ('q%d.ch' % i),
                                      quiet=True))
        assert readers[0].time_diff_order != readers[1].time_diff_order
        outs = decompress_multi(readers)
        for out, arr in zip(outs, arrs):
            assert np.array_equal(out, arr)
    finally:
        for r in readers:
            r.close()


def test_device_path_rejects_foreign_itemsize(tmp_path_):
    """A sidecar whose dtype disagrees with the containers must raise
    the documented IOError on the device path too (never decode
    garbage)."""
    import json
    arr = to_int16(make_signal('colored', ns=2 * 2000, nc=12))
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=2000.0, n_channels=12, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12)
    meta = json.loads((tmp_path_ / 'd.ch').read_text())
    meta['dtype'] = 'int32'
    meta['n_channels'] = 6               # keep n_elems consistent
    (tmp_path_ / 'd.ch').write_text(json.dumps(meta))
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', quiet=True,
                   device='cpu')
    try:
        with pytest.raises(IOError):
            r.to_array()
    finally:
        r.close()


def test_auto_routing_follows_link_profile(tmp_path_, monkeypatch):
    """auto mode routes random-access windows by the MEASURED link: a
    slow link (30 ms sync, ~10 MB/s fetch) takes the host path, a
    PCIe-grade link stays on the device. Writer auto follows the same
    profile for encode."""
    import jax
    import mtscomp_tpu.api as api_mod
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel import pipeline as pl
    # The small-file gate (no device below ~256 MB) is pinned open so
    # the link-profile decision itself is under test.
    monkeypatch.setattr(api_mod, 'AUTO_DEVICE_MIN_BYTES', 0)
    # Realistic chunk mass (1-s chunks of 120 ch @ 16 kHz ~= 3.8 MB):
    # the decision separates ~100x-different links, not byte-counting.
    sr, nc = 16000, 120
    arr = to_int16(make_signal('colored', ns=4 * sr, nc=nc))
    path = write_arr(tmp_path_ / 'l.bin', arr)
    compress(path, tmp_path_ / 'l.cbin', tmp_path_ / 'l.ch',
             sample_rate=float(sr), n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True)
    r = decompress(tmp_path_ / 'l.cbin', tmp_path_ / 'l.ch', quiet=True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    try:
        # Slow link: every decoded byte crosses the slow link,
        # so both bulk and window reads must use the host path.
        monkeypatch.setattr(pl, '_LINK_PROFILE', (0.030, 10e6))
        assert r._use_device() is False                 # bulk
        assert r._use_device(window=(0, sr)) is False
        assert r._use_device(window=(0, 4 * sr)) is False
        # PCIe-grade link: the device wins both.
        monkeypatch.setattr(pl, '_LINK_PROFILE', (0.0002, 10e9))
        assert r._use_device() is True                  # bulk
        assert r._use_device(window=(0, sr)) is True
        # __getitem__ still returns correct data whichever path runs.
        monkeypatch.setattr(pl, '_LINK_PROFILE', (0.030, 10e6))
        assert np.array_equal(r[700:2300], arr[700:2300])
    finally:
        r.close()
    # Writer auto: slow link -> host encode; PCIe -> device encode.
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=1000.0, n_channels=16, dtype='int16')
        monkeypatch.setattr(pl, '_LINK_PROFILE', (0.030, 10e6))
        assert w._use_device() is False
        monkeypatch.setattr(pl, '_LINK_PROFILE', (0.0002, 10e9))
        assert w._use_device() is True
    finally:
        w.close()


def test_host_profile_measures_and_caches(tmp_path_, monkeypatch):
    """host_profile() measures real single-core codec rates (finite,
    positive) and persists them beside the link profile; a fresh
    process state reads the cache back instead of re-probing."""
    from mtscomp_tpu.parallel import pipeline as pl
    monkeypatch.setattr(pl, '_HOST_PROFILE', None)
    monkeypatch.setattr(pl, '_profile_cache_path',
                        lambda name: str(tmp_path_ / name))
    enc, dec = pl.host_profile()
    assert 0 < enc < float('inf')
    assert 0 < dec < float('inf')
    assert (tmp_path_ / 'host_profile.json').exists()
    # Fresh in-process state: served from the disk cache, not re-probed.
    monkeypatch.setattr(pl, '_HOST_PROFILE', None)
    monkeypatch.setattr(pl, '_measure_host_rates', lambda: (_ for _ in ())
                        .throw(AssertionError('re-probed')))
    assert pl.host_profile() == (enc, dec)


def test_auto_routing_uses_measured_host_rate(tmp_path_, monkeypatch):
    """Auto decisions derive from BOTH measurements: with the link held
    fixed, a fast-measured host keeps the work on the host and a
    slow-measured host routes it to the device — a mis-calibrated
    hardcoded constant can no longer flip the route."""
    import jax
    import mtscomp_tpu.api as api_mod
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel import pipeline as pl
    monkeypatch.setattr(api_mod, 'AUTO_DEVICE_MIN_BYTES', 0)
    sr, nc = 4000, 32
    arr = to_int16(make_signal('colored', ns=4 * sr, nc=nc))
    path = write_arr(tmp_path_ / 'm.bin', arr)
    compress(path, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
             sample_rate=float(sr), n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    monkeypatch.setattr(pl, '_LINK_PROFILE', (0.001, 1e9))  # fixed link
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        import multiprocessing
        cores = min(multiprocessing.cpu_count(), 8)
        monkeypatch.setattr(pl, '_HOST_PROFILE', (300e6, 2e9 / cores))
        assert r._use_device() is False           # fast host wins
        monkeypatch.setattr(pl, '_HOST_PROFILE', (300e6, 20e6))
        assert r._use_device() is True            # slow host loses
    finally:
        r.close()
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=float(sr), n_channels=nc, dtype='int16')
        import multiprocessing
        cores = min(multiprocessing.cpu_count(), 8)
        monkeypatch.setattr(pl, '_HOST_PROFILE', (2e9 / cores, 250e6))
        assert w._use_device() is False           # fast host encode
        monkeypatch.setattr(pl, '_HOST_PROFILE', (20e6, 250e6))
        assert w._use_device() is True            # slow host encode
    finally:
        w.close()


def test_link_profile_cpu_backend(monkeypatch):
    """CPU backend: arrays are host-resident; profile is (0, inf) and
    auto behaves as before (size-gated bulk, no per-window probing).
    The on-disk cache (written only by accelerator probes) must not
    shadow the CPU answer."""
    from mtscomp_tpu.parallel import pipeline as pl
    monkeypatch.setattr(pl, '_LINK_PROFILE', None)
    monkeypatch.setattr(pl, '_load_link_cache', lambda: None)
    lat, bw = pl.link_profile()
    assert lat == 0.0 and bw == float('inf')


def test_auto_small_files_never_touch_jax(tmp_path_, monkeypatch):
    """Below AUTO_DEVICE_MIN_BYTES the auto decision is made before any
    JAX call — small CLI invocations must not pay accelerator backend
    init."""
    import jax
    from mtscomp_tpu import Writer
    arr = to_int16(make_signal('colored', ns=2000, nc=8))
    path = write_arr(tmp_path_ / 's.bin', arr)
    compress(path, tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
             sample_rate=1000.0, n_channels=8, dtype='int16',
             algorithm='ans', quiet=True)

    def boom():
        raise AssertionError('JAX touched for a small file')
    monkeypatch.setattr(jax, 'default_backend', boom)
    r = decompress(tmp_path_ / 's.cbin', tmp_path_ / 's.ch', quiet=True)
    try:
        assert r._use_device() is False
        assert r._use_device(window=(0, 100)) is False
        assert np.array_equal(r[100:300], arr[100:300])
    finally:
        r.close()
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=1000.0, n_channels=8, dtype='int16')
        assert w._use_device() is False
    finally:
        w.close()


def test_foreign_min8_tables_container_roundtrip(tmp_path_, monkeypatch, kernel_interpret):
    """A foreign writer's unit-granularity min-8 tables (table
    boundaries not multiples of 8: the decode kernel's full 4096-slot
    symbol table) through the FULL container pipeline — compress with a
    patched quantizer, parse, batch-decode via the GPU kernel
    (interpret mode)."""

    def quantize_foreign(counts, scale_bits=None, min_freq=None):
        scale_bits = rans.SCALE_BITS if scale_bits is None else scale_bits
        min_freq = rans.MIN_FREQ if min_freq is None else min_freq
        counts = np.asarray(counts, dtype=np.int64)
        present = counts > 0
        if int(present.sum()) <= 1:
            return None
        scale = 1 << scale_bits
        ideal = counts * scale / counts.sum()
        freqs = np.floor(ideal).astype(np.int64)
        freqs[present] = np.maximum(freqs[present], min_freq)
        rem = int(scale - freqs.sum())
        if rem > 0:
            frac = np.where(present, ideal - np.floor(ideal), -1.0)
            freqs[np.argsort(-frac, kind='stable')[:rem]] += 1
        while freqs.sum() > scale:
            k = int(np.argmax(freqs))
            freqs[k] -= 1
        return freqs

    # Heavy-tailed diffs: a wide alphabet with many min-frequency
    # symbols is what makes unit-granularity boundaries land three
    # dense ids in one 16-slot bucket.
    rng = np.random.default_rng(9)
    steps = rng.normal(0, 6, size=(2 * 2000 + 500, 24))
    steps[rng.random(steps.shape) < 0.02] *= 30.0
    arr = np.cumsum(steps, axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'f.bin', arr)
    import mtscomp_tpu.codec.ans as ans_mod
    # decide_plane routes through codec.ans._quantize_rows (native fast
    # path); patch that entry so the foreign tables actually land in
    # the file.
    monkeypatch.setattr(
        ans_mod, '_quantize_rows',
        lambda sums: np.stack([quantize_foreign(r) for r in
                               np.asarray(sums)]).astype(np.uint16))
    orig_quantize = rans.quantize_freqs
    rans.quantize_freqs = quantize_foreign
    try:
        compress(path, tmp_path_ / 'f.cbin', tmp_path_ / 'f.ch',
                 sample_rate=2000.0, n_channels=24, dtype='int16',
                 algorithm='ans', quiet=True, ans_table_mode='plane',
                 check_after_compress=False)
    finally:
        rans.quantize_freqs = orig_quantize
    r = decompress(tmp_path_ / 'f.cbin', tmp_path_ / 'f.ch', quiet=True)
    try:
        # The file must genuinely carry tables that are not 8-aligned
        # or the test is vacuous.
        from mtscomp_tpu.codec.ans import seg_freqs
        from mtscomp_tpu.parallel.pipeline import _read_payload
        odd = 0
        for i in range(r.n_chunks):
            parsed = r.codec.parse(_read_payload(r, i))
            for g in parsed['groups']:
                for (p, start, n) in g['segments']:
                    odd += bool(np.any(
                        seg_freqs(parsed, p, start).astype(np.int64) & 7))
        assert odd > 0, "foreign quantizer produced only 8-aligned tables"
        assert np.array_equal(decompress_to_array(r), arr)
        assert np.array_equal(r[:], arr)        # host path agrees
    finally:
        r.close()


def test_device_encode_mixed_mode_batch(tmp_path_):
    """A batch whose chunks pick different plane modes (RAW/RANS near
    the boundary) splits into mode-uniform sub-batches on device instead
    of falling back to host — containers stay byte-identical."""
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel.pipeline import DeviceBatchEncoder
    rng = np.random.default_rng(11)
    n, c = 1000, 32
    smooth = np.cumsum(rng.normal(0, 3, size=(n, c)), axis=0).astype(np.int16)
    noisy = rng.integers(-32768, 32768, size=(n, c)).astype(np.int16)
    arr = np.concatenate([smooth, noisy], axis=0)
    path = write_arr(tmp_path_ / 'm.bin', arr)
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=float(n), n_channels=c, dtype='int16')
        assert w.n_chunks == 2
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(2)])
        host = [w.codec.encode(w._transform_chunk(chunks[b]),
                               order=w.chunk_order) for b in range(2)]
        # The two chunks must actually disagree on some plane's mode
        # (that is the scenario under test).
        p0 = w.codec.parse(host[0])
        p1 = w.codec.parse(host[1])
        assert p0['modes'] != p1['modes']
        enc = DeviceBatchEncoder(w)
        assert enc.supported(n)
        payloads = enc.encode_batch(chunks)
        assert payloads is not None, "mixed-mode batch fell back to host"
        assert payloads[0] == host[0] and payloads[1] == host[1]
    finally:
        w.close()


def test_decompress_multi_mixed_seg_and_tables_exact(tmp_path_):
    """seg_log2/table_mode are PAYLOAD-level (every chunk header
    self-describes them, codec/ans.py container layout) — they are
    deliberately NOT in format.DECODE_IDENTITY_KEYS, so probes mixing
    them are mergeable. The device batch decoder's supported() check
    enforces uniform parsed-chunk geometry and falls back to the host
    per-file path otherwise; either way every probe must round-trip
    exactly."""
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    arrs, readers = [], []
    try:
        for i, (seg, tmode) in enumerate(
                [(12, 'segment'), (10, 'plane'), (12, 'plane')]):
            arr = to_int16(make_signal('colored', ns=2 * 2000, nc=12)) + i
            path = write_arr(tmp_path_ / ('s%d.bin' % i), arr)
            compress(path, tmp_path_ / ('s%d.cbin' % i),
                     tmp_path_ / ('s%d.ch' % i), sample_rate=2000.0,
                     n_channels=12, dtype='int16', algorithm='ans',
                     quiet=True, ans_seg_log2=seg, ans_table_mode=tmode)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('s%d.cbin' % i),
                                      tmp_path_ / ('s%d.ch' % i),
                                      quiet=True))
        outs = decompress_multi(readers)
        for out, arr in zip(outs, arrs):
            assert np.array_equal(out, arr)
    finally:
        for r in readers:
            r.close()


def test_decompress_multi_mixed_algorithms_fall_back(tmp_path_):
    """A zlib probe among ans probes must route down the host fallback
    (ZlibCodec has no parse()/device decoder — this crashed with
    AttributeError instead of decoding); single-probe calls and
    all-zlib calls must work too."""
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    arrs, readers = [], []
    try:
        for i, alg in enumerate(['zlib', 'ans', 'ans']):
            arr = to_int16(make_signal('colored', ns=2 * 2000, nc=9)) + i
            path = write_arr(tmp_path_ / ('a%d.bin' % i), arr)
            compress(path, tmp_path_ / ('a%d.cbin' % i),
                     tmp_path_ / ('a%d.ch' % i), sample_rate=2000.0,
                     n_channels=9, dtype='int16', algorithm=alg,
                     quiet=True)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('a%d.cbin' % i),
                                      tmp_path_ / ('a%d.ch' % i),
                                      quiet=True))
        for sel in ([0, 1, 2], [0], [0, 0]):
            outs = decompress_multi([readers[i] for i in sel])
            for i, out in zip(sel, outs):
                assert np.array_equal(out, arrs[i])
    finally:
        for r in readers:
            r.close()


def test_decompress_multi_rejects_short_probe(tmp_path_):
    """One COMMON chunk range is the contract: a probe shorter than the
    requested range must raise the crafted ValueError (was a raw
    IndexError from the fallback), and restricting last_chunk to the
    common prefix must decode exactly."""
    from mtscomp_tpu.parallel.pipeline import decompress_multi
    arrs, readers = [], []
    try:
        for i, ns in enumerate([5 * 2000, 2 * 2000]):
            arr = to_int16(make_signal('colored', ns=ns, nc=9)) + i
            path = write_arr(tmp_path_ / ('u%d.bin' % i), arr)
            compress(path, tmp_path_ / ('u%d.cbin' % i),
                     tmp_path_ / ('u%d.ch' % i), sample_rate=2000.0,
                     n_channels=9, dtype='int16', algorithm='ans',
                     quiet=True)
            arrs.append(arr)
            readers.append(decompress(tmp_path_ / ('u%d.cbin' % i),
                                      tmp_path_ / ('u%d.ch' % i),
                                      quiet=True))
        with pytest.raises(ValueError, match='common chunk range'):
            decompress_multi(readers)
        # Degenerate ranges get the crafted contract error too (not a
        # raw reshape/IndexError further down).
        with pytest.raises(ValueError, match='invalid chunk range'):
            decompress_multi(readers, first_chunk=-1, last_chunk=1)
        with pytest.raises(ValueError, match='invalid chunk range'):
            decompress_multi(readers, first_chunk=1, last_chunk=0)
        outs = decompress_multi(readers, last_chunk=1)
        for out, arr in zip(outs, arrs):
            assert np.array_equal(out, arr[:out.shape[0]])
            assert out.shape[0] == 2 * 2000
    finally:
        for r in readers:
            r.close()


def test_tofile_device_route_end_to_end(tmp_path_, monkeypatch, kernel_interpret):
    """Drive Reader.tofile through the DEVICE pipeline (the use_device
    branch of produce(), api.py tofile): device='cpu' forces the route,
    batch_chunks=2 makes the double-buffered produce/write overlap span
    several batches. Byte-equality against the source is the contract;
    the to_array spy proves every batch went through the device bulk
    span decoder (writable=False buffers), not the host pool.
    """
    from mtscomp_tpu.api import Reader
    arr = to_int16(make_signal('colored', ns=7 * 2000, nc=21))
    path = write_arr(tmp_path_ / 'tf.bin', arr)
    compress(path, tmp_path_ / 'tf.cbin', tmp_path_ / 'tf.ch',
             sample_rate=2000.0, n_channels=21, dtype='int16',
             algorithm='ans', quiet=True)
    calls = []
    orig = Reader.to_array

    def spy(self, first_chunk=0, last_chunk=None, writable=True):
        calls.append((first_chunk, last_chunk, writable))
        return orig(self, first_chunk, last_chunk, writable=writable)

    monkeypatch.setattr(Reader, 'to_array', spy)
    r = decompress(tmp_path_ / 'tf.cbin', tmp_path_ / 'tf.ch', quiet=True,
                   device='cpu', batch_chunks=2,
                   check_after_decompress=False)
    try:
        assert r._use_device()
        out = tmp_path_ / 'tf_out.bin'
        r.tofile(out)
        got = np.fromfile(out, dtype=np.int16).reshape(arr.shape)
        assert np.array_equal(got, arr)
        # 7 chunks / batch_chunks=2 -> 4 device batches, all read-only.
        assert len(calls) == 4
        assert all(not writable for (_, _, writable) in calls)
        assert [c[:2] for c in calls] == [(0, 1), (2, 3), (4, 5), (6, 6)]
    finally:
        r.close()


def test_tofile_device_route_sharded(tmp_path_, monkeypatch):
    """Same device-routed tofile seam with the 8-device mesh sharding
    the batch decode underneath (decompress_to_array mesh path), so the
    produce()/write overlap is exercised against sharded outputs (XLA
    scan decoder on the CPU backend, same as the other mesh tests)."""
    from mtscomp_tpu.api import Reader
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload)
    arr = to_int16(make_signal('colored', ns=8 * 2000, nc=21))
    path = write_arr(tmp_path_ / 'tfs.bin', arr)
    compress(path, tmp_path_ / 'tfs.cbin', tmp_path_ / 'tfs.ch',
             sample_rate=2000.0, n_channels=21, dtype='int16',
             algorithm='ans', quiet=True)
    mesh = chunk_mesh(n_devices=8)
    orig = Reader.to_array

    def sharded_to_array(self, first_chunk=0, last_chunk=None,
                         writable=True):
        last = self.n_chunks - 1 if last_chunk is None else last_chunk
        if last - first_chunk + 1 == 8:
            parsed = [self.codec.parse(_read_payload(self, i))
                      for i in range(first_chunk, last + 1)]
            ns = self.chunk_bounds[first_chunk + 1] \
                - self.chunk_bounds[first_chunk]
            dec = DeviceBatchDecoder(self)
            assert dec.supported(parsed, ns)
            out = dec.decode_batch(parsed, ns, mesh=mesh)
            return out.reshape(-1, self.n_channels)
        return orig(self, first_chunk, last_chunk, writable=writable)

    monkeypatch.setattr(Reader, 'to_array', sharded_to_array)
    r = decompress(tmp_path_ / 'tfs.cbin', tmp_path_ / 'tfs.ch', quiet=True,
                   device='cpu', batch_chunks=8,
                   check_after_decompress=False)
    try:
        assert r._use_device()
        out = tmp_path_ / 'tfs_out.bin'
        r.tofile(out)
        got = np.fromfile(out, dtype=np.int16).reshape(arr.shape)
        assert np.array_equal(got, arr)
    finally:
        r.close()


def test_auto_routing_many_core_fast_link(tmp_path_, monkeypatch):
    """Routing model on a many-core host behind a PCIe-grade link: the
    host pool is credited at most HOST_POOL_SCALING_CORES cores
    (scaling beyond 8 is unverified — api.py provenance notes), so a
    64-core box must decide exactly like an 8-core one, and the
    fast-link decision follows the measured host rate through the
    clamp. Pins the documented failure direction: when the clamp
    undercredits a wide host, the route errs toward the device."""
    import jax
    import multiprocessing
    import mtscomp_tpu.api as api_mod
    from mtscomp_tpu import Writer
    from mtscomp_tpu.parallel import pipeline as pl
    monkeypatch.setattr(api_mod, 'AUTO_DEVICE_MIN_BYTES', 0)
    sr, nc = 4000, 32
    arr = to_int16(make_signal('colored', ns=4 * sr, nc=nc))
    path = write_arr(tmp_path_ / 'w.bin', arr)
    compress(path, tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch',
             sample_rate=float(sr), n_channels=nc, dtype='int16',
             algorithm='ans', quiet=True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    monkeypatch.setattr(pl, '_LINK_PROFILE', (0.0002, 12e9))  # PCIe-grade
    monkeypatch.setattr(multiprocessing, 'cpu_count', lambda: 64)
    r = decompress(tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch', quiet=True)
    w = Writer(algorithm='ans', quiet=True)
    try:
        w.open(path, sample_rate=float(sr), n_channels=nc, dtype='int16')
        # Host decode credited 8 x 1 GB/s = 8 GB/s < 12 GB/s link ->
        # device; encode 8 x 400 MB/s = 3.2 < cap 4 GB/s -> device.
        monkeypatch.setattr(pl, '_HOST_PROFILE', (400e6, 1e9))
        assert r._use_device() is True
        assert w._use_device() is True
        # A 600 MB/s-per-core encoder crosses the 4 GB/s cap at 8
        # credited cores (4.8 > 4) -> host, no matter how many physical
        # cores exist (the clamp makes 64 == 8).
        monkeypatch.setattr(pl, '_HOST_PROFILE', (600e6, 1.6e9))
        assert w._use_device() is False
        assert r._use_device() is False         # 8 x 1.6 = 12.8 > 12
        monkeypatch.setattr(multiprocessing, 'cpu_count', lambda: 8)
        assert w._use_device() is False
        assert r._use_device() is False
    finally:
        w.close()
        r.close()


def _ragged_geometry_file(tmp_path_, name, dtype='int16', **kw):
    """129 channels at ans_seg_log2=12 -> k=4-channel segments, 33 per
    plane: the 1-channel ragged tail segment splits into 8 sub-rows
    (flags bit6) -> groups [32, 8] — the 385th-channel geometry scaled
    down.
    """
    rng = np.random.default_rng(7)
    C, T = 129, 1000
    arr = np.cumsum(rng.normal(0, 5, size=(4 * T, C)),
                    axis=0).astype(dtype)
    path = write_arr(tmp_path_ / (name + '.bin'), arr)
    compress(path, tmp_path_ / (name + '.cbin'), tmp_path_ / (name + '.ch'),
             sample_rate=1000.0, n_channels=C, dtype=dtype,
             algorithm='ans', quiet=True, ans_seg_log2=12,
             check_after_compress=False, **kw)
    return arr, C, T


def test_ragged_tail_split_bit_exact(tmp_path_, monkeypatch, kernel_interpret):
    """Ragged-tail sub-rows (flags bit6) through the GPU decode kernel
    (interpret mode): the short tail group bounds its own loop, the
    decode is bit-exact and passes the word audit."""
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload,
                                               check_words_used)
    arr, C, T = _ragged_geometry_file(tmp_path_, 'rg')
    r = decompress(tmp_path_ / 'rg.cbin', tmp_path_ / 'rg.ch', quiet=True)
    try:
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(4)]
        assert [len(g['segments']) for g in parsed[0]['groups']] == [32, 8]
        assert parsed[0]['tail_split'] == 8
        dec = DeviceBatchDecoder(r)
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
        # Tail group rows: 8 sub-rows of 128 symbols (one step) against
        # the full groups' 4-channel segments.
        counts = np.asarray(args[3]).reshape(4, 2, 32)
        assert (counts[:, 1, :8] == 128).all() and not counts[:, 1, 8:].any()
        out, used = fn(*args)
        check_words_used(parsed, used)
        assert np.array_equal(np.asarray(out).reshape(arr.shape), arr)
        # Random-access windows ride the same split path (B=1 packs).
        assert np.array_equal(r[700:2300], arr[700:2300])
        # Column-restricted reads incl. the ragged tail channel itself.
        assert np.array_equal(r[:, C - 1], arr[:, C - 1])
        assert np.array_equal(r[:, 126:], arr[:, 126:])
    finally:
        r.close()


@pytest.mark.parametrize('case', ['order2', 'float16'])
def test_ragged_tail_split_variants(tmp_path_, monkeypatch, case, kernel_interpret):
    """bit6 geometry composed with the v2 extensions: second-order
    prediction (two inverse scans) and float16 bitcast (int16 decode +
    reinterpret), through the GPU decode kernel (interpret mode)."""
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload)
    if case == 'order2':
        arr, C, T = _ragged_geometry_file(tmp_path_, 'v', time_diff_order=2)
    else:
        rng = np.random.default_rng(9)
        C, T = 129, 1000
        arr = np.cumsum(rng.normal(0, 0.5, size=(2 * T, C)),
                        axis=0).astype(np.float16)
        path = write_arr(tmp_path_ / 'v.bin', arr)
        compress(path, tmp_path_ / 'v.cbin', tmp_path_ / 'v.ch',
                 sample_rate=1000.0, n_channels=C, dtype='float16',
                 algorithm='ans', quiet=True, ans_seg_log2=12,
                 check_after_compress=False)
    r = decompress(tmp_path_ / 'v.cbin', tmp_path_ / 'v.ch', quiet=True)
    try:
        parsed = [r.codec.parse(_read_payload(r, i))
                  for i in range(r.n_chunks)]
        dec = DeviceBatchDecoder(r)
        if dec.supported(parsed, T):
            fn, args = dec.pack(parsed, T)
            out, _ = fn(*args)
            got = np.asarray(out).reshape(arr.shape)
            if case == 'float16':
                got = got.view(np.float16)
            assert got.tobytes() == arr.tobytes()
        # Whatever the route, the reader contract holds bit-exactly.
        assert r[:].tobytes() == arr.tobytes()
    finally:
        r.close()


def test_ragged_tail_split_mesh(tmp_path_, monkeypatch, kernel_interpret):
    """bit6 geometry under the 8-device mesh with the GPU decode kernel
    (interpret mode) inside shard_map: each device's chunk-major slab
    is self-contained."""
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload,
                                               check_words_used)
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    rng = np.random.default_rng(11)
    C, T = 129, 1000
    arr = np.cumsum(rng.normal(0, 5, size=(8 * T, C)),
                    axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'mg.bin', arr)
    compress(path, tmp_path_ / 'mg.cbin', tmp_path_ / 'mg.ch',
             sample_rate=1000.0, n_channels=C, dtype='int16',
             algorithm='ans', quiet=True, ans_seg_log2=12,
             check_after_compress=False)
    r = decompress(tmp_path_ / 'mg.cbin', tmp_path_ / 'mg.ch', quiet=True)
    try:
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(8)]
        dec = DeviceBatchDecoder(r)
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T, mesh=chunk_mesh(n_devices=8))
        out, used = fn(*args)
        check_words_used(parsed, used)
        assert np.array_equal(np.asarray(out).reshape(arr.shape), arr)
    finally:
        r.close()


def test_tail_split_env_clamps(monkeypatch):
    """MTSCOMP_ENC_TAILSPLIT: '1' and '0' disable; oversized overrides
    clamp to the format cap (the parser rejects > 256) so the writer
    can never emit a container its own reader refuses."""
    import numpy as np
    from mtscomp_tpu.codec.ans import AnsCodec
    rng = np.random.default_rng(1)
    d = np.diff(np.cumsum(rng.normal(0, 5, size=(1000, 129)), axis=0)
                .astype(np.int16), axis=0,
                prepend=np.zeros((1, 129), np.int16))
    codec = AnsCodec(seg_log2=12)
    for env, want in (('0', 1), ('1', 1), ('300', 8), ('4', 4)):
        monkeypatch.setenv('MTSCOMP_ENC_TAILSPLIT', env)
        payload = codec.encode(d, order='F')
        parsed = codec.parse(payload)       # must parse (<= 256 always)
        assert parsed['tail_split'] == want, (env, parsed['tail_split'])
        back = codec.decode(payload, 1000, 129, np.dtype('int16'),
                            order='F')
        assert np.array_equal(back, d)
