"""The GPU backend: the grouped rANS decode kernel, the backend seam, the
compile-cache rule and the plain XLA ops of the device path.

The kernel (``ops/gpu_rans.py``) runs here in Pallas interpret mode on
the CPU backend. Tests marked ``gpu`` compile it for the card and skip
without one; ``python chip_smoke.py`` runs them on the card.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu import compress, decompress  # noqa: E402
from mtscomp_tpu.config import read_config  # noqa: E402
from mtscomp_tpu.models import rans  # noqa: E402
from mtscomp_tpu.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu.ops import device_hist, device_rans, gpu_rans  # noqa: E402
from mtscomp_tpu.parallel import pipeline  # noqa: E402

from conftest import write_arr  # noqa: E402

TWO_SYMBOLS = np.array([1, 1] + [0] * 254, dtype=np.int64)


def _min8_tables(counts):
    """Unit-granularity tables with the format's minimum of 8 (another
    writer's choice): boundaries that are not multiples of 8."""
    counts = np.asarray(counts, dtype=np.int64)
    present = counts > 0
    ideal = counts * rans.SCALE / counts.sum()
    f = np.floor(ideal).astype(np.int64)
    f[present] = np.maximum(f[present], rans.MIN_FREQ)
    rem = int(rans.SCALE - f.sum())
    if rem > 0:
        frac = np.where(present, ideal - np.floor(ideal), -1.0)
        f[np.argsort(-frac, kind='stable')[:rem]] += 1
    while f.sum() > rans.SCALE:
        f[int(np.argmax(f))] -= 1
    return f


def _group(case, rng, S):
    """Rows and tables of one group for kernel case ``case``."""
    n_rows = {'empty_rows': 12, 'bit6_subrows': 8}.get(case, 32)
    rows, tables = [], []
    for r in range(n_rows):
        n = S * 128
        if case == 'partial_step':
            n = int(rng.integers(1, S * 128))
        elif case == 'empty_rows' and r % 3 == 0:
            n = 0
        elif case == 'bit6_subrows':
            n = int(rng.integers(90, 140))       # short ragged-tail rows
        alpha = 5.0 if case == 'large_alpha' else 0.05
        syms = rng.choice(256, size=n, p=rng.dirichlet(np.full(256, alpha)))
        syms = syms.astype(np.uint8)
        counts = np.bincount(syms, minlength=256)
        if np.count_nonzero(counts) < 2:
            counts = counts + TWO_SYMBOLS
        quantize = _min8_tables if case == 'min8' else rans.quantize_freqs
        rows.append(syms)
        tables.append(quantize(counts))
    return rows, np.stack(tables)


def _pack(groups, S):
    """Batch arrays of the device decoders from (rows, tables) groups."""
    N = len(groups)
    states = np.full((N, rans.GROUP_ROWS, rans.LANES), rans.RANS_L, np.uint32)
    freqs = np.zeros((N, rans.GROUP_ROWS, 256), np.int32)
    freqs[:] = rans.quantize_freqs(TWO_SYMBOLS)
    counts = np.zeros((N, rans.GROUP_ROWS), np.int32)
    streams = []
    for g, (rows, tables) in enumerate(groups):
        R = len(rows)
        st, words = rans.rans_encode_group(rows, tables)
        states[g, :R] = st
        freqs[g, :R] = tables
        counts[g, :R] = [r.size for r in rows]
        streams.append(words)
    W = max(w.size for w in streams) + 5
    words = np.zeros((N, W), np.uint16)
    for g, w in enumerate(streams):
        words[g, :w.size] = w
    return states, words, freqs, counts, streams


@pytest.mark.parametrize('case', ['aligned8', 'min8', 'large_alpha',
                                  'partial_step', 'empty_rows',
                                  'bit6_subrows'])
def test_decode_kernel_matches_normative_and_scan(case):
    """The kernel in interpret mode decodes every row exactly as
    ``models/rans.py`` and the XLA scan, and reports the same stream
    words consumed, with the symbol table at full and at 1/8 size."""
    rng = np.random.default_rng(sum(map(ord, case)))
    S = 3
    groups = [_group(case, rng, S) for _ in range(2)]
    states, words, freqs, counts, streams = _pack(groups, S)
    aligned8 = not np.any(freqs & 7)
    assert aligned8 == (case != 'min8')
    fq = jnp.asarray(freqs)
    cum, slot2sym = device_rans.derive_tables(fq)
    scan, scan_used = device_rans.decode_groups(
        jnp.asarray(states), jnp.asarray(words), fq, jnp.asarray(counts),
        n_steps=S)
    scan = np.asarray(jnp.transpose(scan, (0, 2, 1, 3))).reshape(
        len(groups), rans.GROUP_ROWS, S * rans.LANES)
    for shift in ((0, 3) if aligned8 else (0,)):
        fc, sym = gpu_rans.kernel_tables(fq, cum, slot2sym, shift)
        assert sym.shape[-1] == rans.SCALE >> shift
        out, used = gpu_rans.decode_groups_kernel(
            jnp.asarray(states), jnp.asarray(words), sym, fc,
            jnp.asarray(counts), n_steps=S, shift=shift, interpret=True)
        out, used = np.asarray(out), np.asarray(used)
        assert out.shape == (len(groups), rans.GROUP_ROWS, S * rans.LANES)
        assert list(used) == [w.size for w in streams]
        assert list(np.asarray(scan_used)) == list(used)
        for g, (rows, tables) in enumerate(groups):
            ref, n_used = rans.rans_decode_group(
                states[g, :len(rows)], streams[g], tables,
                counts[g, :len(rows)])
            assert n_used == used[g]
            for r, row in enumerate(rows):
                assert np.array_equal(out[g, r, :row.size], row)
                assert np.array_equal(ref[r], row)
                assert np.array_equal(scan[g, r, :row.size], row)


@pytest.mark.parametrize('dtype,table_mode', [
    ('int8', 'plane'), ('uint16', 'plane'), ('int32', 'plane'),
    ('int8', 'segment'), ('int16', 'segment'), ('uint16', 'segment')])
def test_pipeline_kernel_interpret_dtypes_and_tables(tmp_path_, monkeypatch,
                                                     kernel_interpret,
                                                     dtype, table_mode):
    """Bulk decode through the kernel (every batch counted as a kernel
    batch) is byte-exact for each coded dtype path and table mode."""
    seen = []
    monkeypatch.setattr(pipeline, 'count',
                        lambda name, n=1: seen.append((name, n)))
    info = np.iinfo(dtype)
    rng = np.random.default_rng(7)
    walk = np.cumsum(np.rint(rng.normal(0, 5, (3 * 1000, 11))), axis=0)
    arr = ((walk.astype(np.int64) - info.min) % (int(info.max) - info.min + 1)
           + info.min).astype(dtype)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=1000.0, n_channels=11, dtype=dtype,
             algorithm='ans', quiet=True, device='none', ans_seg_log2=11,
             ans_table_mode=table_mode, check_after_compress=False)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', device='cpu')
    try:
        out = pipeline.decompress_to_array(r)
    finally:
        r.close()
    assert out.tobytes() == arr.tobytes()
    assert ('decode.batches.cpu.kernel', 1) in seen
    assert not [s for s in seen if s[0] == 'decode.host_chunks']


@pytest.mark.parametrize('platform,decoder', [('gpu', 'kernel'),
                                              ('cpu', 'scan')])
def test_device_coders_per_platform(monkeypatch, platform, decoder):
    monkeypatch.setattr(pipeline, 'device_platform', lambda: platform)
    c = pipeline.device_coders()
    assert (c.platform, c.decoder, c.encoder, c.interpret) == (
        platform, decoder, 'scan', False)


def test_device_coders_interpret_only_when_asked_on_cpu(monkeypatch):
    """Interpret mode follows from asking for the kernel on the CPU
    backend, never from a missing GPU."""
    monkeypatch.setattr(pipeline, 'DECODER', 'kernel')
    monkeypatch.setattr(pipeline, 'device_platform', lambda: 'cpu')
    assert pipeline.device_coders().interpret
    monkeypatch.setattr(pipeline, 'device_platform', lambda: 'gpu')
    assert not pipeline.device_coders().interpret
    monkeypatch.setattr(pipeline, 'DECODER', 'scan')
    assert pipeline.device_coders().decoder == 'scan'


@pytest.mark.parametrize('platform', ['rocm', 'METAL'])
def test_device_coders_other_platforms_raise(monkeypatch, platform):
    monkeypatch.setattr(pipeline, 'device_platform', lambda: platform)
    with pytest.raises(RuntimeError, match=platform):
        pipeline.device_coders()


def test_forced_gpu_without_gpu_raises(tmp_path_):
    """device='gpu' never runs on the CPU: compress and decode raise."""
    arr = np.arange(4000 * 3, dtype=np.int16).reshape(-1, 3)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    kw = dict(sample_rate=1000.0, n_channels=3, dtype='int16',
              algorithm='ans', quiet=True)
    with pytest.raises(RuntimeError, match="device='gpu'"):
        compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
                 device='gpu', **kw)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', device='none',
             **kw)
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', device='gpu')
    try:
        with pytest.raises(RuntimeError, match='no GPU'):
            r.to_array()
    finally:
        r.close()
    pipeline.check_device('cpu')


@pytest.mark.parametrize('where', ['kwargs', 'config_file', 'cli'])
def test_tpu_device_name_raises(tmp_path_, where):
    import json
    import mtscomp_tpu.config as config_mod
    if where == 'kwargs':
        with pytest.raises(ValueError, match="'gpu'"):
            read_config(device='tpu')
    elif where == 'config_file':
        config_mod.CONFIG_PATH.write_text(json.dumps({'device': 'tpu'}))
        with pytest.raises(ValueError, match="'gpu'"):
            read_config()
    else:
        from mtscomp_tpu.cli import mtscomp
        arr = np.zeros((2000, 2), np.int16)
        path = write_arr(tmp_path_ / 'd.bin', arr)
        with pytest.raises(ValueError, match="'gpu'"):
            mtscomp([str(path), '-d', 'int16', '-s', '1000', '-n', '2',
                     '-a', 'ans', '--device', 'tpu'])


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path / 'cc'))
    assert pipeline.compile_cache_dir() == str(tmp_path / 'cc')


def test_compile_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    repo = Path(pipeline.__file__).resolve().parents[2]
    assert Path(pipeline.compile_cache_dir()) == repo / '.jax_cache'
    assert '.jax_cache/' in (repo / '.gitignore').read_text().split()


@pytest.mark.parametrize('shape', [(4, 1000), (3, 128), (2, 300000),
                                   (5, 1)])
def test_histogram256_matches_bincount(shape):
    v = np.random.default_rng(shape[1]).integers(0, 256, shape,
                                                 dtype=np.uint8)
    got = np.asarray(device_hist.histogram256(jnp.asarray(v)))
    want = np.stack([np.bincount(row, minlength=256) for row in v])
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize('dtype', ['int8', 'uint8', 'int16', 'uint16',
                                   'int32', 'uint32'])
def test_cumsum_wraps_for_every_int_width(dtype):
    """diff -> cumsum round trips over the full range of each integer
    width: the in-dtype scans wrap exactly as the host ops do."""
    info = np.iinfo(dtype)
    x = np.random.default_rng(3).integers(info.min, info.max, (2, 300, 5),
                                          endpoint=True, dtype=dtype)
    d = np.asarray(dd.diff_time_jnp(jnp.asarray(x)))
    with np.errstate(over='ignore'):
        assert np.array_equal(d[:, 1:], np.diff(x, axis=1))
    assert np.array_equal(np.asarray(dd.cumsum_time_jnp(jnp.asarray(d))), x)
    s = dd.diff_space_jnp(jnp.asarray(x))
    assert np.array_equal(np.asarray(dd.cumsum_space_jnp(s)), x)


@pytest.mark.gpu
def test_decode_kernel_compiled_on_gpu(gpu):
    """The compiled kernel equals the XLA scan on the card."""
    rng = np.random.default_rng(5)
    S = 4
    groups = [_group(c, rng, S) for c in ('aligned8', 'partial_step',
                                          'empty_rows', 'bit6_subrows')]
    states, words, freqs, counts, streams = _pack(groups, S)
    fq = jnp.asarray(freqs)
    cum, slot2sym = device_rans.derive_tables(fq)
    fc, sym = gpu_rans.kernel_tables(fq, cum, slot2sym, 3)
    out, used = gpu_rans.decode_groups_kernel(
        jnp.asarray(states), jnp.asarray(words), sym, fc,
        jnp.asarray(counts), n_steps=S, shift=3)
    out = np.asarray(out)
    assert list(np.asarray(used)) == [w.size for w in streams]
    for g, (rows, _t) in enumerate(groups):
        for r, row in enumerate(rows):
            assert np.array_equal(out[g, r, :row.size], row)


@pytest.mark.gpu
def test_device_route_on_gpu_roundtrip(gpu, tmp_path_):
    """compress and decode with device='gpu': byte-exact, no host chunk."""
    rng = np.random.default_rng(6)
    arr = np.cumsum(np.rint(rng.normal(0, 6, (8 * 3000, 64))),
                    axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'd.bin', arr)
    compress(path, tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch',
             sample_rate=3000.0, n_channels=64, dtype='int16',
             algorithm='ans', quiet=True, device='gpu')
    r = decompress(tmp_path_ / 'd.cbin', tmp_path_ / 'd.ch', device='gpu')
    try:
        assert r.to_array().tobytes() == arr.tobytes()
        assert r[1234:5678].tobytes() == arr[1234:5678].tobytes()
    finally:
        r.close()
