"""Measure the five BASELINE.json configs; print a markdown report.

Usage::

    python -m mtscomp_tpu.benchmarks.baseline_report [--seconds S]

Device decode rates are measured on staged compressed batches (the
compressed batch is uploaded once, each timed decode ends in
``block_until_ready``), like the headline bench: repeated host<->device
transfer would measure the link, not the codec. Sizes are scaled down
from the nominal configs; rates are size-independent past a few
chunks. The report names the device it ran on.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .harness import bench_tmpdir


def _median_time(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _synth(ns, nc, diff_std, seed=0):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0.0, diff_std, size=(ns, nc)), axis=0)
    return walk.astype(np.int16)


def _synth_gradient(ns, nc, lo, hi, seed=0):
    """Per-channel step size swept log-uniformly lo..hi (LFP-like
    amplitude gradient along the probe)."""
    rng = np.random.default_rng(seed)
    stds = np.logspace(np.log10(lo), np.log10(hi), nc)
    walk = np.cumsum(rng.normal(0.0, 1.0, size=(ns, nc)) * stds, axis=0)
    return np.clip(walk, -30000, 30000).astype(np.int16)


def _staged_decode_rate(r, T, arr, reps):
    """Staged device decode GB/s + byte-exactness for a Reader."""
    import jax
    from ..parallel.pipeline import DeviceBatchDecoder, _read_payload
    parsed = [r.codec.parse(_read_payload(r, i)) for i in range(r.n_chunks)]
    dec = DeviceBatchDecoder(r)
    if not dec.supported(parsed, T):
        return None, False
    fn, dev_args = dec.pack(parsed, T)
    out, _used = fn(*dev_args)
    exact = np.array_equal(np.asarray(out).reshape(arr.shape), arr)
    dt = _median_time(lambda: jax.block_until_ready(fn(*dev_args)), reps)
    return arr.nbytes / 1e9 / dt, exact


def config1_cpu_roundtrip(reps, out):
    """256-ch int16 @20 kHz roundtrip on the host paths (both algos)."""
    from .. import compress, decompress
    arr = _synth(20000 * 10, 256, 4.0)
    tmp = bench_tmpdir()
    arr.tofile(tmp / 'c1.bin')
    rows = []
    for algo in ('zlib', 'ans'):
        ratio = [None]

        def do_compress(algo=algo, ratio=ratio):
            ratio[0] = compress(
                tmp / 'c1.bin', tmp / ('c1%s.cbin' % algo),
                tmp / ('c1%s.ch' % algo), sample_rate=20000.0,
                n_channels=256, dtype='int16', algorithm=algo,
                quiet=True, check_after_compress=False)

        wt = _median_time(do_compress, max(1, reps // 2))
        r = decompress(tmp / ('c1%s.cbin' % algo), tmp / ('c1%s.ch' % algo),
                       quiet=True, device='none')
        dec = [None]

        def do_decode(r=r, dec=dec):
            # Repeated timed reads must re-decode, not hit the
            # random-access LRU.
            r.read_chunk.cache_clear()
            dec[0] = r[:]

        rt = _median_time(do_decode, reps)
        exact = np.array_equal(dec[0], arr)
        r.close()
        rows.append((algo, 1 / ratio[0], arr.nbytes / 1e6 / wt,
                     arr.nbytes / 1e6 / rt, exact))
    out.append("## Config 1 — 256-ch int16 @20 kHz, host (CPU) roundtrip\n")
    out.append("| algorithm | ratio | compress MB/s | decompress MB/s | "
               "byte-exact |")
    out.append("|---|---|---|---|---|")
    for algo, ratio, w, rd, ex in rows:
        out.append("| %s | %.2fx | %.0f | %.0f | %s |"
                   % (algo, ratio, w, rd, ex))
    out.append("")


def config2_neuropixels(seconds, reps, out):
    """385-ch int16 @30 kHz: compress + staged device decompress + check."""
    from .. import compress, decompress, check
    from ..io_host import load_raw_data
    arr = _synth(30000 * seconds, 385, 6.0)
    tmp = bench_tmpdir()
    arr.tofile(tmp / 'c2.bin')
    t0 = time.perf_counter()
    ratio = compress(tmp / 'c2.bin', tmp / 'c2.cbin', tmp / 'c2.ch',
                     sample_rate=30000.0, n_channels=385, dtype='int16',
                     algorithm='ans', quiet=True,
                     check_after_compress=False)
    wt = time.perf_counter() - t0
    data = load_raw_data(tmp / 'c2.bin', n_channels=385, dtype=np.int16)
    t0 = time.perf_counter()
    check(data, tmp / 'c2.cbin', tmp / 'c2.ch')   # full verify (host)
    ct = time.perf_counter() - t0
    r = decompress(tmp / 'c2.cbin', tmp / 'c2.ch', quiet=True)
    try:
        gbps, exact = _staged_decode_rate(r, 30000, arr, reps)
    finally:
        r.close()
    out.append("## Config 2 — Neuropixels AP: 385-ch int16 @30 kHz "
               "(%d s)\n" % seconds)
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| compression ratio | %.2fx |" % (1 / ratio))
    out.append("| host compress | %.0f MB/s |" % (arr.nbytes / 1e6 / wt))
    out.append("| device decompress (staged) | %s |"
               % ("%.2f GB/s" % gbps if gbps is not None
                  else "n/a (host path)"))
    out.append("| full compress-then-verify (host) | %.0f MB/s |"
               % (arr.nbytes / 1e6 / ct))
    out.append("| byte-exact | %s |" % exact)
    out.append("")


def config3_lfp_windows(reps, out):
    """LFP band 385-ch @2.5 kHz: random window reads r[i0:i1]."""
    from .. import compress, decompress
    arr = _synth_gradient(2500 * 240, 385, 3.0, 40.0)   # 4 min of LFP
    tmp = bench_tmpdir()
    arr.tofile(tmp / 'c3.bin')
    ratio = compress(tmp / 'c3.bin', tmp / 'c3.cbin', tmp / 'c3.ch',
                     sample_rate=2500.0, n_channels=385, dtype='int16',
                     algorithm='ans', quiet=True,
                     ans_table_mode='segment',
                     check_after_compress=False)
    ratio_plane = compress(tmp / 'c3.bin', tmp / 'c3p.cbin', tmp / 'c3p.ch',
                           sample_rate=2500.0, n_channels=385,
                           dtype='int16', algorithm='ans', quiet=True,
                           ans_table_mode='plane',
                           check_after_compress=False)
    rng = np.random.default_rng(1)
    lat = {}
    for device, label in (('none', 'host'), (None, 'auto (default)')):
        kw = {'device': device} if device else {}
        r = decompress(tmp / 'c3.cbin', tmp / 'c3.ch', quiet=True, **kw)
        try:
            n = r.shape[0]
            idx = [int(rng.integers(0, n - 2500)) for _ in range(12)]
            win = r[idx[0]:idx[0] + 2500]            # warm-up
            assert np.array_equal(win, arr[idx[0]:idx[0] + 2500])
            ts = []
            for i0 in idx:
                t0 = time.perf_counter()
                _ = r[i0:i0 + 2500]
                ts.append(time.perf_counter() - t0)
            lat[label] = sorted(ts)[len(ts) // 2] * 1e3
        finally:
            r.close()
    out.append("## Config 3 — LFP: 385-ch int16 @2.5 kHz, random 1-s "
               "window reads\n")
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| compression ratio (segment tables) | %.2fx |"
               % (1 / ratio))
    out.append("| compression ratio (plane tables) | %.2fx |"
               % (1 / ratio_plane))
    for label, ms in lat.items():
        out.append("| window read latency (%s) | %.1f ms |" % (label, ms))
    out.append("")
    out.append("(auto routes each window by the measured accelerator "
               "link: where a device round trip costs more than the host "
               "codec it takes the host codec, otherwise the window is "
               "served from the device chunk cache.)")
    out.append("")


def config4_multiprobe(seconds, reps, out):
    """4 x 384-ch probes decoded in one merged device batch."""
    from .. import compress, decompress
    import jax
    from ..parallel.pipeline import (DeviceBatchDecoder, _read_payload,
                                     decompress_multi)
    tmp = bench_tmpdir()
    readers, arrs = [], []
    for p in range(4):
        arr = _synth(30000 * seconds, 384, 6.0, seed=p)
        arrs.append(arr)
        arr.tofile(tmp / ('p%d.bin' % p))
        compress(tmp / ('p%d.bin' % p), tmp / ('p%d.cbin' % p),
                 tmp / ('p%d.ch' % p), sample_rate=30000.0, n_channels=384,
                 dtype='int16', algorithm='ans', quiet=True,
                 check_after_compress=False)
        readers.append(decompress(tmp / ('p%d.cbin' % p),
                                  tmp / ('p%d.ch' % p), quiet=True))
    try:
        outs = decompress_multi(readers)
        exact = all(np.array_equal(o, a) for o, a in zip(outs, arrs))
        # Staged rate over the merged batch.
        parsed = []
        for r in readers:
            parsed.extend(r.codec.parse(_read_payload(r, i))
                          for i in range(r.n_chunks))
        dec = DeviceBatchDecoder(readers[0])
        if not dec.supported(parsed, 30000):
            out.append("## Config 4 — multi-probe: device batch "
                       "unsupported in this environment\n")
            return
        fn, dev_args = dec.pack(parsed, 30000)
        dt = _median_time(lambda: jax.block_until_ready(fn(*dev_args)),
                          reps)
        total = sum(a.nbytes for a in arrs)
    finally:
        for r in readers:
            r.close()
    out.append("## Config 4 — multi-probe: 4 x 384-ch int16 @30 kHz, "
               "merged device batch (%d s each)\n" % seconds)
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| aggregate device decompress (staged) | %.2f GB/s |"
               % (total / 1e9 / dt))
    out.append("| byte-exact (all probes) | %s |" % exact)
    out.append("| multi-chip | chunk batch shards over a mesh "
               "(shard_map; validated on the 8-device virtual mesh) |")
    out.append("")


def config5_legacy(out):
    """Reference-written zlib .cbin -> our reader -> re-encode as ans."""
    sys.path.insert(0, '/root/reference')
    tmp = bench_tmpdir()
    arr = _synth(30000 * 4, 385, 6.0)
    arr.tofile(tmp / 'c5.bin')
    try:
        import mtscomp as ref
        ref.compress(tmp / 'c5.bin', tmp / 'c5.cbin', tmp / 'c5.ch',
                     sample_rate=30000.0, n_channels=385, dtype=np.int16,
                     check_after_compress=False)
        who = 'reference-written'
    except Exception:      # reference unavailable: use our legacy writer
        from .. import compress
        compress(tmp / 'c5.bin', tmp / 'c5.cbin', tmp / 'c5.ch',
                 sample_rate=30000.0, n_channels=385, dtype='int16',
                 algorithm='zlib', quiet=True, check_after_compress=False)
        who = 'self-written (reference unavailable)'
    from .. import compress, decompress
    r = decompress(tmp / 'c5.cbin', tmp / 'c5.ch', quiet=True)
    try:
        dec = r[:]
        exact = np.array_equal(dec, arr)
        zlib_size = (tmp / 'c5.cbin').stat().st_size
    finally:
        r.close()
    dec.tofile(tmp / 'c5r.bin')
    ratio = compress(tmp / 'c5r.bin', tmp / 'c5r.cbin', tmp / 'c5r.ch',
                     sample_rate=30000.0, n_channels=385, dtype='int16',
                     algorithm='ans', quiet=True,
                     check_after_compress=False)
    out.append("## Config 5 — legacy interop: %s zlib .cbin\n" % who)
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| legacy file decoded byte-exactly | %s |" % exact)
    out.append("| legacy zlib ratio | %.2fx |"
               % (arr.nbytes / zlib_size))
    out.append("| re-encoded (ans) ratio | %.2fx |" % (1 / ratio))
    out.append("")


def config6_float(out):
    """Float recordings: bit-exactness + ratio of the v2 bitcast
    transform vs the reference's float-domain zlib (which is only
    allclose, and whose automatic check can fail near zero crossings).
    """
    from mtscomp_tpu import compress, decompress
    tmp = bench_tmpdir()
    rng = np.random.default_rng(6)
    nc = 64
    arr = np.cumsum(rng.normal(0.0, 1.0, size=(20 * 2500, nc)),
                    axis=0).astype(np.float32)
    arr -= arr.mean(axis=0, keepdims=True)
    arr.tofile(tmp / 'c6.bin')
    rows = {}
    for algo in ('zlib', 'ans'):
        ratio = compress(tmp / 'c6.bin', tmp / ('c6%s.cbin' % algo),
                         tmp / ('c6%s.ch' % algo), sample_rate=2500.0,
                         n_channels=nc, dtype='float32', algorithm=algo,
                         quiet=True, check_after_compress=False)
        r = decompress(tmp / ('c6%s.cbin' % algo),
                       tmp / ('c6%s.ch' % algo), quiet=True)
        try:
            dec = r[:]
            exact = np.array_equal(dec.view(np.uint32),
                                   arr.view(np.uint32))
        finally:
            r.close()
        rows[algo] = (1 / ratio, exact)
    out.append("## Config 6 — float32 LFP-like: 64-ch @2.5 kHz "
               "(byte-exact floats are v2-only)\n")
    out.append("| algorithm | ratio | bit-exact round trip |")
    out.append("|---|---|---|")
    out.append("| zlib (reference float semantics) | %.2fx | %s |"
               % (rows['zlib'][0], rows['zlib'][1]))
    out.append("| ans (bitcast transform) | %.2fx | %s |"
               % (rows['ans'][0], rows['ans'][1]))
    out.append("")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--seconds', type=int, default=8,
                   help='seconds of 30 kHz data per probe')
    p.add_argument('--reps', type=int, default=5)
    args = p.parse_args(argv)
    import jax
    d = jax.devices()[0]
    backend = '%s, %s, %d device(s)' % (d.platform, d.device_kind,
                                        len(jax.devices()))
    import mtscomp_tpu.config as cfg
    cfg.CONFIG_PATH = Path(tempfile.mkdtemp()) / '.mtscomp'
    out = ["# BASELINE.json config measurements",
           "",
           "Backend: `%s`. Generated by "
           "`python -m mtscomp_tpu.benchmarks.baseline_report`. "
           "See the module docstring for methodology (staged device "
           "batches; sizes scaled down)." % backend,
           ""]
    config1_cpu_roundtrip(args.reps, out)
    config2_neuropixels(args.seconds, args.reps, out)
    config3_lfp_windows(args.reps, out)
    config4_multiprobe(max(2, args.seconds // 4), args.reps, out)
    config5_legacy(out)
    config6_float(out)
    print('\n'.join(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
