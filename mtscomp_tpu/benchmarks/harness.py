"""Benchmark harness: timed compress / decompress / read over a param grid.

Functional equivalent of the reference's ``benchmark.py`` (mtscomp_perf,
dataset x parameter grid, tabulated report; reference benchmark.py:16-99)
rebuilt for this framework: synthetic dataset generators replace the
on-disk sample files, the grid covers both algorithms on the host
paths (pass device=True to mtscomp_perf to time the device pipeline
including transfers), and results are plain dicts (JSON-friendly)
rather than joblib-cached pickles.

Usage::

    from mtscomp_tpu.benchmarks import run_grid, format_report
    rows = run_grid(duration=10.0)
    print(format_report(rows))
"""

import itertools
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def bench_tmp_base():
    """Directory for benchmark working files: tmpfs when available.

    Some dev VMs expose a write-through virtio disk (~10-60 MB/s
    synchronous; the page cache never absorbs writes), which would make
    every write-inclusive timing measure that disk instead of the
    codec. tmpfs keeps the file IO real (same syscalls, memmap and
    pread paths) at page-cache speed. Returns None (system default)
    when /dev/shm is absent.
    """
    return '/dev/shm' if os.path.isdir('/dev/shm') else None


def bench_tmpdir():
    """Benchmark temp dir on :func:`bench_tmp_base`, removed at process
    exit (tmpfs leaks would eat RAM, not disk)."""
    import atexit
    d = Path(tempfile.mkdtemp(dir=bench_tmp_base()))
    atexit.register(shutil.rmtree, d, True)
    return d


DATASETS = {
    # name: (n_channels, sample_rate, diff_std) — AP band and LFP band
    # with statistics comparable to Neuropixels recordings
    # (reference dataset: imec_385_100s.bin, benchmark.py:13).
    # diff_std may be a (low, high) pair: per-channel step sizes swept
    # log-uniformly across the probe (the amplitude gradient real LFP
    # bands show along the shank — what per-segment tables exploit).
    'ap_385': (385, 30000.0, 6.0),
    'lfp_385': (385, 2500.0, (3.0, 40.0)),
    'small_64': (64, 20000.0, 4.0),
}


def make_dataset(name, duration, seed=0):
    """Synthesize an int16 recording with realistic diff entropy."""
    n_channels, sample_rate, diff_std = DATASETS[name]
    ns = int(duration * sample_rate)
    rng = np.random.default_rng(seed)
    if isinstance(diff_std, tuple):
        lo, hi = diff_std
        stds = np.logspace(np.log10(lo), np.log10(hi), n_channels)
    else:
        stds = np.full(n_channels, float(diff_std))
    walk = np.cumsum(rng.normal(0.0, 1.0, size=(ns, n_channels)) * stds,
                     axis=0)
    return np.clip(walk, -30000, 30000).astype(np.int16), sample_rate


def mtscomp_perf(arr, sample_rate, algorithm='ans', n_threads=None,
                 chunk_duration=1.0, device=False, read_windows=20):
    """Time one compress/decompress cycle; returns a metrics dict.

    ``device=True`` times the device pipeline INCLUDING host<->device
    transfers (``baseline_report`` has the staged device rates without
    them).
    """
    from .. import compress, decompress
    from ..parallel.pipeline import decompress_to_array

    tmp = Path(tempfile.mkdtemp(dir=bench_tmp_base()))
    raw = tmp / 'data.bin'
    arr.tofile(raw)
    nc = arr.shape[1]

    t0 = time.perf_counter()
    ratio = compress(raw, tmp / 'data.cbin', tmp / 'data.ch',
                     sample_rate=sample_rate, n_channels=nc,
                     dtype=arr.dtype, algorithm=algorithm, quiet=True,
                     n_threads=n_threads, chunk_duration=chunk_duration,
                     check_after_compress=False)
    write_time = time.perf_counter() - t0

    r = decompress(tmp / 'data.cbin', tmp / 'data.ch', quiet=True,
                   device=None if device else 'none')
    try:
        # Bulk decode.
        t0 = time.perf_counter()
        if device and algorithm == 'ans':
            out = decompress_to_array(r)
        else:
            out = r[:]
        bulk_time = time.perf_counter() - t0
        assert np.array_equal(out, arr)
        # Random window reads (BASELINE config 3).
        rng = np.random.default_rng(1)
        n = arr.shape[0]
        t0 = time.perf_counter()
        for _ in range(read_windows):
            i0 = int(rng.integers(0, max(1, n - 1000)))
            _ = r[i0:i0 + 1000]
        window_time = (time.perf_counter() - t0) / read_windows
    finally:
        r.close()
        shutil.rmtree(tmp, ignore_errors=True)

    nbytes = arr.nbytes
    return {
        'algorithm': algorithm,
        'n_threads': n_threads,
        'chunk_duration': chunk_duration,
        'ratio': round(1.0 / ratio, 3),
        'write_mbps': round(nbytes / 1e6 / write_time, 1),
        'read_mbps': round(nbytes / 1e6 / bulk_time, 1),
        'window_ms': round(window_time * 1e3, 2),
    }


def run_grid(duration=10.0, datasets=('ap_385',),
             algorithms=('zlib', 'ans'), thread_counts=(1, 4)):
    """Run the benchmark grid; returns a list of result dicts."""
    rows = []
    for name, algorithm, n_threads in itertools.product(
            datasets, algorithms, thread_counts):
        arr, sr = make_dataset(name, duration)
        row = {'dataset': name}
        row.update(mtscomp_perf(arr, sr, algorithm=algorithm,
                                n_threads=n_threads))
        rows.append(row)
    return rows


def format_report(rows):
    """Plain-text table of grid results."""
    if not rows:
        return '(no results)'
    cols = list(rows[0])
    widths = [max(len(str(c)), max(len(str(r.get(c, ''))) for r in rows))
              for c in cols]
    header = '  '.join(str(c).ljust(w) for c, w in zip(cols, widths))
    lines = [header, '-' * len(header)]
    for r in rows:
        lines.append('  '.join(str(r.get(c, '')).ljust(w)
                               for c, w in zip(cols, widths)))
    return '\n'.join(lines)


if __name__ == '__main__':  # pragma: no cover
    print(format_report(run_grid()))
