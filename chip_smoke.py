#!/usr/bin/env python
"""Smoke test of the codec's device path on one GPU (``--cards 4``: four).

Drives the main path through the entry points a user calls, at the
reference's own benchmark size: 385 channels, 30 kHz, 100 s, uint16,
1-s chunks (2.31 GB raw). The data is synthetic from ``--seed``: an
AP-band random walk (cumulative sum of rounded N(0, 6) steps, wrapped to
uint16). Every phase compares bytes and raises on a mismatch.

Phases, in order:

1. the tests marked ``gpu`` (in a child, before this process opens the
   card); device report (platform, card, power limit, native runtime);
2. the decode kernel compiled at the real geometry, compared byte for
   byte with the normative coder (``models/rans.py``) and the XLA scan;
   the encode scan compared with the containers and the normative coder;
3. ``compress(..., device='gpu')`` with compress-then-verify, every
   batch on the device encoder (trace counters), sampled containers
   equal to the host codec's;
4. ``decompress`` on the device route: ``tofile``, ``to_array``, 20
   random 1-s windows, ``mtsverify --deep``; no chunk on the host;
5. a format matrix through the device decoder and encoder;
6. one line each of timings and of what ``device='auto'`` would choose.

The last line of standard output is one JSON object with the device.
With ``--cards 4`` only the multi-card path runs: four 100-s probes
decoded through a 4-device chunk mesh and encode batches sharded the
same way, compared with one card and with the raw data.

Run from the repository root: ``python chip_smoke.py [--cards 4]``.
"""

import os

# A CUDA plugin that fails to load must be an error, not a CPU run.
os.environ['JAX_PLATFORMS'] = 'cuda'

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

C, SR, SECONDS, DTYPE = 385, 30000, 100, 'uint16'


_T0 = time.perf_counter()


def log(*a):
    print("[%7.1f s]" % (time.perf_counter() - _T0), *a, flush=True)


def card_line():
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def make_raw(path, seconds, seed):
    """AP-band walk written second by second (bounded host memory)."""
    channels = C
    rng = np.random.default_rng(seed)
    carry = np.zeros(channels, np.int16)
    with open(path, 'wb') as f:
        for _ in range(seconds):
            step = np.rint(6.0 * rng.standard_normal(
                (SR, channels), dtype=np.float32)).astype(np.int16)
            # int16 sums wrap like the uint16 file does.
            block = np.cumsum(step, axis=0, dtype=np.int16) + carry
            carry = block[-1]
            block.view(np.uint16).tofile(f)
    return np.memmap(path, dtype=DTYPE, mode='r').reshape(-1, channels)


def counters():
    from mtscomp_tpu.utils.trace import phase_stats
    return {k: v[0] for k, v in phase_stats().items()}


def delta(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


def timed(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- phase 1 ------------------------------------------------------------------

def phase_report(n_cards):
    t0 = time.perf_counter()
    import jax
    devs = jax.devices()
    init_s = time.perf_counter() - t0
    d = devs[0]
    from mtscomp_tpu import native
    card = card_line()
    log("device: platform=%s kind=%s count=%d" % (
        d.platform, d.device_kind, len(devs)))
    log("card: %s" % card)
    log("native runtime loaded: %s" % native.available())
    if d.platform != 'gpu':
        raise RuntimeError("expected a GPU, JAX found %r" % d.platform)
    if len(devs) < n_cards:
        raise RuntimeError("need %d GPUs, found %d" % (n_cards, len(devs)))
    return d, card, init_s


def phase_gpu_tests():
    """The tests marked ``gpu``, in a child process that releases the
    card before this one takes it (one JAX process per card)."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, '-m', 'pytest', '-q', '-m', 'gpu',
         '-p', 'no:cacheprovider', 'tests'], cwd=root, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS='cuda'))
    lines = p.stdout.strip().splitlines()
    summary = lines[-1] if lines else ''
    log("tests marked gpu: %s (%.1f s)" % (summary,
                                           time.perf_counter() - t0))
    if p.returncode != 0 or 'passed' not in summary or 'skipped' in summary:
        raise AssertionError("tests marked gpu did not all pass on the "
                             "card:\n%s\n%s" % (p.stdout[-4000:],
                                                 p.stderr[-2000:]))


# -- phase 2 ------------------------------------------------------------------

def host_containers(raw, ids, **kw):
    """Host-codec containers of chunks ``ids`` (the reference path)."""
    from mtscomp_tpu import Writer
    w = Writer(algorithm='ans', quiet=True, device='none', **kw)
    try:
        w.open(raw, sample_rate=SR, n_channels=C, dtype=DTYPE)
        out = []
        for i in ids:
            p = w._compress_chunk(i)[1][1]
            out.append(b''.join(p) if isinstance(p, list) else p)
        return out
    finally:
        w.close()


def phase_kernels(raw, n_chunks, card):
    import jax
    import jax.numpy as jnp
    from mtscomp_tpu.codec.ans import AnsCodec, seg_freqs
    from mtscomp_tpu.models import rans
    from mtscomp_tpu.ops import device_rans, gpu_rans
    codec = AnsCodec()
    parsed = [codec.parse(p)
              for p in host_containers(raw, range(n_chunks))]
    groups, owner = [], []
    for p in parsed:
        groups += p['groups']
        owner += [p] * len(p['groups'])
    log("kernel batch: %d chunks, %d groups (rows per group %s), "
        "flags bit6 tail split %s" % (
            n_chunks, len(groups),
            [len(g['segments']) for g in parsed[0]['groups']],
            parsed[0].get('tail_split', 1)))
    states, words, freqs, counts, S = device_rans.pack_groups(
        groups, lambda i, p, start: seg_freqs(owner[i], p, start))
    st, wd, fq, ct = (jnp.asarray(a) for a in (states, words, freqs,
                                               counts))
    want = np.array([g['words'].size for g in groups])
    shift = 0 if np.any(freqs & 7) else 3
    cum, s2s = device_rans.derive_tables(fq)
    fc, sym = gpu_rans.kernel_tables(fq, cum, s2s, shift)
    t0 = time.perf_counter()
    compiled = gpu_rans.decode_groups_kernel.lower(
        st, wd, sym, fc, ct, n_steps=S, shift=shift).compile()
    compile_s = time.perf_counter() - t0
    log("decode kernel compiled in %.2f s (steps %d, shift %d); "
        "memory_analysis: %s" % (compile_s, S, shift,
                                 compiled.memory_analysis()))
    out, used = compiled(st, wd, sym, fc, ct)
    out, used = np.asarray(out), np.asarray(used)
    ref, used_s = device_rans.decode_groups(st, wd, fq, ct, n_steps=S)
    ref = np.asarray(jnp.transpose(ref, (0, 2, 1, 3))).reshape(
        len(groups), rans.GROUP_ROWS, S * rans.LANES)
    if not (np.array_equal(used, want)
            and np.array_equal(np.asarray(used_s), want)):
        raise AssertionError("word audit: kernel/scan consumed other "
                             "word counts than the containers store")
    for i, g in enumerate(groups):
        for r, (_p, _s, n) in enumerate(g['segments']):
            if not np.array_equal(out[i, r, :n], ref[i, r, :n]):
                raise AssertionError("kernel != XLA scan, group %d row %d"
                                     % (i, r))
    # The normative coder on the first chunk's groups.
    n_first = len(parsed[0]['groups'])
    for i in range(n_first):
        g = groups[i]
        rows, used_n = rans.rans_decode_group(
            g['states'], g['words'], freqs[i, :len(g['segments'])],
            counts[i, :len(g['segments'])])
        if used_n != want[i] or any(
                not np.array_equal(out[i, r, :row.size], row)
                for r, row in enumerate(rows)):
            raise AssertionError("kernel != models/rans.py, group %d" % i)
    log("decode kernel == XLA scan on %d groups, == models/rans.py on "
        "%d groups: OK" % (len(groups), n_first))

    # Encode scan on the decoded rows: states and streams equal to the
    # containers (host codec) and to the normative encoder.
    col = np.arange(S * rans.LANES)[None, None, :]
    sy = jnp.asarray(np.where(col < counts[:, :, None], out, 0))
    pk, rcp = rans.encoder_tables(freqs)
    enc = jax.jit(lambda a, b, c, d: device_rans.encode_groups(
        a, b, c, d, n_steps=S))
    t0 = time.perf_counter()
    st_e, wd_e, em = enc(sy, jnp.asarray(pk), jnp.asarray(rcp), ct)
    streams, nw = device_rans.compact_words(wd_e, em, int(want.max()))
    st_e, streams, nw = (np.asarray(a) for a in (st_e, streams, nw))
    log("encode scan compiled+ran in %.2f s" % (time.perf_counter() - t0))
    for i, g in enumerate(groups):
        R = len(g['segments'])
        if not (np.array_equal(st_e[i, :R], g['states'])
                and nw[i] == want[i]
                and np.array_equal(streams[i, :nw[i]], g['words'])):
            raise AssertionError("encode scan != container, group %d" % i)
    for i in range(n_first):
        g = groups[i]
        R = len(g['segments'])
        st_n, wd_n = rans.rans_encode_group(
            [out[i, r, :counts[i, r]] for r in range(R)], freqs[i, :R])
        if not (np.array_equal(st_n, g['states'])
                and np.array_equal(wd_n, g['words'])):
            raise AssertionError("models/rans.py encode != container")
    log("encode scan == containers on %d groups, models/rans.py encode "
        "== containers on %d groups: OK" % (len(groups), n_first))
    return compile_s


# -- phase 3 ------------------------------------------------------------------

def phase_compress(raw, tmp, n_chunks):
    from mtscomp_tpu import compress
    from mtscomp_tpu.parallel.pipeline import _read_payload
    from mtscomp_tpu import decompress
    before = counters()
    t0 = time.perf_counter()
    ratio = compress(raw, tmp / 'ap.cbin', tmp / 'ap.ch', sample_rate=SR,
                     n_channels=C, dtype=DTYPE, algorithm='ans',
                     device='gpu', quiet=True)
    wall = time.perf_counter() - t0
    after = counters()
    dev = delta(before, after, 'encode.device_chunks')
    host = delta(before, after, 'encode.host_chunks')
    log("compress: %d chunks device-encoded, %d host-encoded, ratio %.4f, "
        "verify on" % (dev, host, 1.0 / ratio))
    if dev != n_chunks or host != 0:
        raise AssertionError("compress did not run every chunk on the "
                             "device encoder (%d device, %d host)"
                             % (dev, host))
    sample = [0, 1, n_chunks // 2, n_chunks - 1]
    hosts = host_containers(raw, sample)
    r = decompress(tmp / 'ap.cbin', tmp / 'ap.ch', quiet=True,
                   device='none')
    try:
        for i, h in zip(sample, hosts):
            if _read_payload(r, i) != h:
                raise AssertionError("chunk %d: device container != host "
                                     "codec container" % i)
    finally:
        r.close()
    log("compress: containers of chunks %s == AnsCodec.encode: OK" % sample)
    return wall


# -- phase 4 ------------------------------------------------------------------

def phase_decompress(raw_arr, tmp, seed):
    from mtscomp_tpu import decompress
    from mtscomp_tpu.cli import mtsverify
    before = counters()
    r = decompress(tmp / 'ap.cbin', tmp / 'ap.ch', quiet=True,
                   device='gpu', check_after_decompress=False)
    try:
        out = tmp / 'ap_out.bin'
        t0 = time.perf_counter()
        r.tofile(out)
        tofile_s = time.perf_counter() - t0
        got = np.memmap(out, dtype=DTYPE, mode='r').reshape(-1, C)
        for a in range(0, raw_arr.shape[0], SR * 10):
            if not np.array_equal(got[a:a + SR * 10], raw_arr[a:a + SR * 10]):
                raise AssertionError("tofile differs from the raw file at "
                                     "sample %d" % a)
        del got
        out.unlink()
        log("decompress: tofile == raw: OK (%.2f s)" % tofile_s)
        arr = r.to_array()
        if not np.array_equal(arr, raw_arr):
            raise AssertionError("to_array differs from the raw file")
        del arr
        log("decompress: to_array == raw: OK")
        rng = np.random.default_rng(seed + 1)
        for _ in range(20):
            i0 = int(rng.integers(0, raw_arr.shape[0] - SR))
            if not np.array_equal(r[i0:i0 + SR], raw_arr[i0:i0 + SR]):
                raise AssertionError("window [%d, %d) differs" % (i0,
                                                                  i0 + SR))
        if r._dev_cache is None:
            raise AssertionError("windows did not use the device cache")
        log("decompress: 20 random 1-s windows == raw (device chunk "
            "cache): OK")
    finally:
        r.close()
    mtsverify([str(tmp / 'ap.cbin'), '--cpus', str(os.cpu_count() or 1)])
    after = counters()
    dev = delta(before, after, 'decode.device_chunks')
    host = delta(before, after, 'decode.host_chunks')
    log("decompress: %d chunk decodes on the device, %d on the host "
        "fallback; mtsverify --deep: OK" % (dev, host))
    if host or not dev:
        raise AssertionError("a decode batch fell back to the host")
    return tofile_s


# -- phase 5 ------------------------------------------------------------------

def _foreign_quantizer():
    """Unit-granularity min-8 tables, as another writer may emit them."""
    from mtscomp_tpu.models import rans

    def quantize(counts, scale_bits=None, min_freq=None):
        counts = np.asarray(counts, dtype=np.int64)
        present = counts > 0
        if int(present.sum()) <= 1:
            return None
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
    return quantize


def storm_cells(seed):
    rng = np.random.default_rng(seed + 2)
    # 6 full chunks + a partial: enough that a first chunk whose plane
    # modes differ (order 2) leaves a device-sized batch behind it.
    ns = int(6.5 * SR)

    def walk(std, dtype, nc=C):
        info = np.iinfo(dtype)
        w = np.cumsum(np.rint(rng.normal(0, std, (ns, nc))).astype(np.int64),
                      axis=0)
        return (w - info.min) % (int(info.max) - info.min + 1) + info.min

    cells = []
    for dt in ('int8', 'uint8', 'int16', 'uint16', 'int32', 'uint32'):
        cells.append(('dtype_' + dt, walk(3 if dt.endswith('int8') else 6,
                                          np.dtype(dt)).astype(dt), {}))
    base = walk(6, np.int16).astype(np.int16)
    cells += [
        ('plane_tables', base, dict(ans_table_mode='plane')),
        ('non_aligned', base, dict(ans_channel_segments=False,
                                   ans_table_mode='plane')),
        ('chunk_order_C', base, dict(chunk_order='C',
                                     ans_table_mode='plane')),
        ('spatial_diff', base, dict(do_spatial_diff=True)),
        ('time_diff_off', base, dict(do_time_diff=False)),
        ('order2', base, dict(time_diff_order=2)),
        ('bit5_adaptive', base, dict(transform_adapt=4,
                                     chunk_duration=0.5)),
        ('bit6_129ch', walk(6, np.int16, 129).astype(np.int16),
         dict(ans_seg_log2=14)),
        ('foreign_min8', base, dict(ans_table_mode='plane')),
    ]
    return cells


def phase_storm(tmp, seed):
    import mtscomp_tpu.codec.ans as ans_mod
    from mtscomp_tpu import compress, decompress
    from mtscomp_tpu.codec.ans import seg_freqs
    from mtscomp_tpu.models import rans
    from mtscomp_tpu.parallel.pipeline import _read_payload
    n_cells = 0
    for name, arr, kw in storm_cells(seed):
        nc = arr.shape[1]
        raw = tmp / ('%s.bin' % name)
        arr.tofile(raw)
        common = dict(sample_rate=SR, n_channels=nc, dtype=arr.dtype.name,
                      algorithm='ans', quiet=True,
                      check_after_compress=False, **kw)
        foreign = name == 'foreign_min8'
        orig = (ans_mod._quantize_rows, rans.quantize_freqs)
        if foreign:
            q = _foreign_quantizer()
            ans_mod._quantize_rows = lambda sums: np.stack(
                [q(r) for r in np.asarray(sums)]).astype(np.uint16)
            rans.quantize_freqs = q
        try:
            compress(raw, tmp / 'h.cbin', tmp / 'h.ch', device='none',
                     **common)
        finally:
            ans_mod._quantize_rows, rans.quantize_freqs = orig
        before = counters()
        enc_dev = 0
        if not foreign:
            compress(raw, tmp / 'd.cbin', tmp / 'd.ch', device='gpu',
                     **common)
            mid = counters()
            enc_dev = delta(before, mid, 'encode.device_chunks')
            if (tmp / 'd.cbin').read_bytes() != (tmp / 'h.cbin').read_bytes():
                raise AssertionError("storm %s: device-encoded file != host "
                                     "codec file" % name)
            if arr.dtype.itemsize <= 2 and not enc_dev:
                raise AssertionError("storm %s: no chunk ran on the device "
                                     "encoder" % name)
        before = counters()
        r = decompress(tmp / 'h.cbin', tmp / 'h.ch', quiet=True,
                       device='gpu', check_after_decompress=False)
        try:
            if foreign and not any(
                    np.any(seg_freqs(p, pl, s).astype(np.int64) & 7)
                    for p in [r.codec.parse(_read_payload(r, 0))]
                    for g in p['groups'] for pl, s, _n in g['segments']):
                raise AssertionError("foreign cell has only 8-aligned "
                                     "tables")
            got = r.to_array()
            if got.tobytes() != arr.tobytes():
                raise AssertionError("storm %s: device decode != raw" % name)
            if r[SR // 3:SR // 3 + SR].tobytes() != \
                    arr[SR // 3:SR // 3 + SR].tobytes():
                raise AssertionError("storm %s: window != raw" % name)
        finally:
            r.close()
        after = counters()
        dec_dev = delta(before, after, 'decode.device_chunks')
        dec_host = delta(before, after, 'decode.host_chunks')
        kern = delta(before, after, 'decode.batches.gpu.kernel')
        scan = delta(before, after, 'decode.batches.gpu.scan')
        if dec_host or not dec_dev or not (kern or scan):
            raise AssertionError("storm %s: decode not on the GPU decoder "
                                 "(%d device, %d host)"
                                 % (name, dec_dev, dec_host))
        log("storm %-14s dtype %-6s encode: device %d chunks | decode: "
            "device %d chunks (%d kernel, %d scan batches), host %d: OK"
            % (name, arr.dtype.name, enc_dev, dec_dev, kern, scan,
               dec_host))
        n_cells += 1
    # A corrupted byte must raise IOError on the device route.
    data = bytearray((tmp / 'h.cbin').read_bytes())
    data[len(data) // 2] ^= 0x5A
    (tmp / 'h.cbin').write_bytes(bytes(data))
    r = decompress(tmp / 'h.cbin', tmp / 'h.ch', quiet=True, device='gpu',
                   check_after_decompress=False)
    try:
        r.to_array()
    except IOError as e:
        log("storm corrupted_byte: IOError raised: OK (%s)" % e)
    else:
        raise AssertionError("a corrupted byte decoded without an IOError")
    finally:
        r.close()
    return n_cells + 1


# -- phase 6 ------------------------------------------------------------------

def phase_staged(raw, tmp, card):
    from mtscomp_tpu import Writer, decompress
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               DeviceBatchEncoder,
                                               _read_payload,
                                               check_words_used,
                                               device_batch_chunks)
    B = min(device_batch_chunks(SR * C * 2), SECONDS)
    r = decompress(tmp / 'ap.cbin', tmp / 'ap.ch', quiet=True,
                   device='gpu', check_after_decompress=False)
    try:
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(B)]
        dec = DeviceBatchDecoder(r)
        fn, args = dec.pack(parsed, SR)
        t0 = time.perf_counter()
        out, used = fn(*args)
        check_words_used(parsed, used)
        first = time.perf_counter() - t0
        dec_s = timed(lambda: fn(*args))
    finally:
        r.close()
    w = Writer(algorithm='ans', quiet=True, device='gpu')
    try:
        w.open(raw, sample_rate=SR, n_channels=C, dtype=DTYPE)
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(B)])
        enc = DeviceBatchEncoder(w)
        if enc.encode_batch(chunks) is None:
            raise AssertionError("device encoder declined the batch")
        efn, eargs = enc.last_staged
        enc_s = timed(lambda: efn(*eargs))
    finally:
        w.close()
    nbytes = B * SR * C * 2
    return dict(batch_chunks=B, groups=len(parsed) * len(parsed[0]['groups']),
                decode_s=dec_s, decode_first_s=first, encode_s=enc_s,
                decode_gbps=nbytes / dec_s / 1e9,
                encode_gbps=nbytes / enc_s / 1e9)


def phase_auto(raw, tmp, card):
    from mtscomp_tpu import Writer, decompress
    from mtscomp_tpu.parallel.pipeline import host_profile, link_profile
    lat, bw = link_profile(refresh=True)
    enc_rate, dec_rate = host_profile()
    r = decompress(tmp / 'ap.cbin', tmp / 'ap.ch', quiet=True,
                   device='auto', check_after_decompress=False)
    try:
        bulk = r._use_device()
        window = r._use_device(window=(SR * 10, SR * 11))
    finally:
        r.close()
    w = Writer(algorithm='ans', quiet=True, device='auto')
    try:
        w.open(raw, sample_rate=SR, n_channels=C, dtype=DTYPE)
        encode = w._use_device()
    finally:
        w.close()
    route = lambda b: 'device' if b else 'host'  # noqa: E731
    log("auto [%s]: link sync %.6f s, fetch %.3e B/s; host codec per core "
        "encode %.3e B/s, decode %.3e B/s -> encode %s, bulk decode %s, "
        "1-s window %s" % (card, lat, bw, enc_rate, dec_rate, route(encode),
                           route(bulk), route(window)))


# -- multi-card ---------------------------------------------------------------

def run_cards(n_cards, tmp, seed, card):
    from mtscomp_tpu import Writer, compress, decompress
    from mtscomp_tpu.parallel.mesh import chunk_mesh
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchEncoder,
                                               decompress_multi,
                                               decompress_to_array)
    base = make_raw(tmp / 'base.bin', SECONDS, seed)
    raws, readers = [], []
    for k in range(n_cards):
        raw = tmp / ('p%d.bin' % k)
        (np.asarray(base) + np.uint16(k)).tofile(raw)
        compress(raw, tmp / ('p%d.cbin' % k), tmp / ('p%d.ch' % k),
                 sample_rate=SR, n_channels=C, dtype=DTYPE, algorithm='ans',
                 device='none', quiet=True, check_after_compress=False)
        raws.append(raw)
    mesh = chunk_mesh(n_devices=n_cards)
    try:
        readers = [decompress(tmp / ('p%d.cbin' % k), tmp / ('p%d.ch' % k),
                              quiet=True, device='gpu',
                              check_after_decompress=False)
                   for k in range(n_cards)]
        t0 = time.perf_counter()
        outs = decompress_multi(readers, mesh=mesh)
        multi_s = time.perf_counter() - t0
        for k, (r, o) in enumerate(zip(readers, outs)):
            want = np.memmap(raws[k], dtype=DTYPE, mode='r').reshape(-1, C)
            if not np.array_equal(o, want):
                raise AssertionError("probe %d: mesh decode != raw" % k)
            one = decompress_to_array(r)
            if not np.array_equal(one, o):
                raise AssertionError("probe %d: mesh != one card" % k)
        log("cards: %d probes x %d s decoded over a %d-device chunk mesh "
            "in %.2f s, == raw and == one card: OK"
            % (n_cards, SECONDS, n_cards, multi_s))
    finally:
        for r in readers:
            r.close()
    # Encode batches sharded the same way.
    for k, raw in enumerate(raws):
        w = Writer(algorithm='ans', quiet=True, device='gpu')
        try:
            w.open(raw, sample_rate=SR, n_channels=C, dtype=DTYPE)
            chunks = np.stack([np.asarray(w.get_chunk(i))
                               for i in range(4 * n_cards)])
            sharded = DeviceBatchEncoder(w).encode_batch(chunks, mesh=mesh)
            single = DeviceBatchEncoder(w).encode_batch(chunks)
            host = [w._compress_chunk(i)[1][1] for i in range(len(chunks))]
            host = [b''.join(h) if isinstance(h, list) else h for h in host]
            if sharded != single or sharded != host:
                raise AssertionError("probe %d: sharded encode != one card "
                                     "/ host codec" % k)
        finally:
            w.close()
    log("cards: encode batches of %d chunks sharded over %d devices == "
        "one card == host codec on %d probes: OK"
        % (4 * n_cards, n_cards, n_cards))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cards', type=int, default=1, choices=(1, 4))
    a = p.parse_args(argv)
    t_start = time.perf_counter()
    if a.cards == 1:
        phase_gpu_tests()
    d, card, init_s = phase_report(a.cards)
    from mtscomp_tpu.utils.trace import enable_tracing
    enable_tracing(True)
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_',
                                dir=os.environ.get('TMPDIR')))
    try:
        if a.cards > 1:
            run_cards(a.cards, tmp, a.seed, card)
        else:
            t0 = time.perf_counter()
            raw_arr = make_raw(tmp / 'ap.bin', SECONDS, a.seed)
            log("data: %d x %d %s (%.2f GB) in %.1f s" % (
                raw_arr.shape[0], C, DTYPE, raw_arr.nbytes / 1e9,
                time.perf_counter() - t0))
            raw = tmp / 'ap.bin'
            from mtscomp_tpu.parallel.pipeline import device_batch_chunks
            batch = min(device_batch_chunks(SR * C * 2), SECONDS)
            compile_s = phase_kernels(raw, batch, card)
            compress_s = phase_compress(raw, tmp, SECONDS)
            tofile_s = phase_decompress(raw_arr, tmp, a.seed)
            n_cells = phase_storm(tmp, a.seed)
            log("storm: %d cells OK" % n_cells)
            st = phase_staged(raw, tmp, card)
            nbytes = raw_arr.nbytes
            log("report [%s]: compress (device encode + verify) %.3f s = "
                "%.1f MB/s" % (card, compress_s, nbytes / compress_s / 1e6))
            log("report [%s]: tofile (device decode) %.3f s = %.1f MB/s"
                % (card, tofile_s, nbytes / tofile_s / 1e6))
            log("report [%s]: staged device decode, %d chunks / %d groups "
                "per batch: %.6f s = %.3f GB/s" % (
                    card, st['batch_chunks'], st['groups'], st['decode_s'],
                    st['decode_gbps']))
            log("report [%s]: staged device encode, %d chunks per batch: "
                "%.6f s = %.3f GB/s" % (card, st['batch_chunks'],
                                        st['encode_s'], st['encode_gbps']))
            log("report [%s]: backend init %.3f s; decode kernel compile "
                "%.3f s; first staged decode batch %.3f s" % (
                    card, init_s, compile_s, st['decode_first_s']))
            phase_auto(raw, tmp, card)
        log("card: %s; total %.1f s" % (card, time.perf_counter() - t_start))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(__import__('jax').devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
