#!/usr/bin/env python
"""Device A/B timings at the 385-channel AP geometry (GPU only).

Times each hand-written device kernel against what XLA makes of the
plain version, on the card, with every output compared byte for byte
first. Data: synthetic AP band (cumsum of N(0, 6), uint16, 385 ch,
30 kHz, 1-s chunks) from ``--seed``, host-encoded to v2 containers.

Phases (``--phases``, comma separated):

- ``decode``: grouped rANS decode, XLA scan vs the Triton kernel
  (``ops/gpu_rans.py``) over batch sizes and warp counts;
- ``pipeline``: per-batch decode through finalize
  (``DeviceBatchDecoder.pack``) with either decoder;
- ``ops``: plain-XLA times of the encode scan + compaction, the
  inverse time scans, the byte histograms and the table derivation.

Phases run in the order given. Prints one JSON object per measurement
(times in seconds, median of ``--reps``), each with the card's name
and power limit. Usage::

    python tools/device_ab.py --chunks 8,32,64 --phases decode,ops
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

C, SR = 385, 30000


def card():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'unknown'


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, reps):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def make_file(tmp, n_chunks, seed):
    from mtscomp_tpu import compress, decompress
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.normal(0.0, 6.0, size=(n_chunks * SR, C)),
                    axis=0).astype(np.int16).astype(np.uint16)
    raw = Path(tmp) / 'ap.bin'
    arr.tofile(raw)
    compress(raw, Path(tmp) / 'ap.cbin', Path(tmp) / 'ap.ch',
             sample_rate=SR, n_channels=C, dtype='uint16', algorithm='ans',
             quiet=True, device='none', check_after_compress=False)
    r = decompress(Path(tmp) / 'ap.cbin', Path(tmp) / 'ap.ch', quiet=True,
                   device='none')
    return arr, r


def group_arrays(r, n_chunks):
    """Pack the first ``n_chunks`` chunks' groups: device_rans layout."""
    from mtscomp_tpu.codec.ans import seg_freqs
    from mtscomp_tpu.ops.device_rans import pack_groups
    from mtscomp_tpu.parallel.pipeline import _read_payload
    parsed = [r.codec.parse(_read_payload(r, i)) for i in range(n_chunks)]
    groups, owner = [], []
    for parsed_c in parsed:
        for g in parsed_c['groups']:
            groups.append(g)
            owner.append(parsed_c)
    states, words, freqs, counts, S = pack_groups(
        groups, lambda i, p, start: seg_freqs(owner[i], p, start))
    return parsed, groups, states, words, freqs, counts, S


def phase_decode(r, chunk_list, reps, warps_list):
    import jax.numpy as jnp
    from mtscomp_tpu.ops import device_rans, gpu_rans
    for B in chunk_list:
        parsed, groups, states, words, freqs, counts, S = group_arrays(r, B)
        N = len(groups)
        st, wd, fq, ct = (jnp.asarray(a) for a in (states, words, freqs,
                                                   counts))
        want = [g['words'].size for g in groups]
        t0 = time.perf_counter()
        ref, used = device_rans.decode_groups(st, wd, fq, ct, n_steps=S)
        used = np.asarray(used)
        compile_scan = time.perf_counter() - t0
        assert list(used) == want, "scan word audit"
        ref_rows = np.asarray(jnp.transpose(ref, (0, 2, 1, 3)).reshape(
            N, 32, S * 128))
        t_scan = timed(lambda: device_rans.decode_groups(
            st, wd, fq, ct, n_steps=S), reps)
        emit(phase='decode', coder='xla_scan', chunks=B, groups=N,
             steps=S, seconds=t_scan, compile_s=compile_scan, card=card())
        cum, s2s = device_rans.derive_tables(fq)
        aligned8 = not np.any(freqs & 7)
        for shift in ((3, 0) if aligned8 else (0,)):
            fc, sym = gpu_rans.kernel_tables(fq, cum, s2s, shift)
            for nw in warps_list:
                t0 = time.perf_counter()
                out, used_k = gpu_rans.decode_groups_kernel(
                    st, wd, sym, fc, ct, n_steps=S, shift=shift,
                    num_warps=nw)
                out = np.asarray(out)
                compile_k = time.perf_counter() - t0
                assert list(np.asarray(used_k)) == want, "kernel audit"
                for i, g in enumerate(groups):
                    for rr, (_p, _s, n) in enumerate(g['segments']):
                        if not np.array_equal(out[i, rr, :n],
                                              ref_rows[i, rr, :n]):
                            raise AssertionError(
                                "kernel != scan at group %d row %d"
                                % (i, rr))
                t_k = timed(lambda: gpu_rans.decode_groups_kernel(
                    st, wd, sym, fc, ct, n_steps=S, shift=shift,
                    num_warps=nw), reps)
                emit(phase='decode', coder='triton_kernel', chunks=B,
                     groups=N, steps=S, shift=shift, num_warps=nw,
                     seconds=t_k, compile_s=compile_k,
                     speedup_vs_scan=t_scan / t_k, card=card())


def phase_pipeline(r, arr, chunk_list, reps):
    import jax
    from mtscomp_tpu.parallel import pipeline
    from mtscomp_tpu.parallel.pipeline import (DeviceBatchDecoder,
                                               _read_payload,
                                               check_words_used)
    for B in chunk_list:
        parsed = [r.codec.parse(_read_payload(r, i)) for i in range(B)]
        for decoder in ('scan', 'kernel'):
            pipeline.DECODER = decoder
            emit(phase='pipeline', decoder=decoder, chunks=B, start=True)
            dec = DeviceBatchDecoder(r)
            assert dec.supported(parsed, SR)
            fn, args = dec.pack(parsed, SR)
            out, used = fn(*args)
            check_words_used(parsed, used)
            got = np.asarray(out).reshape(-1, C)
            if not np.array_equal(got, arr[:B * SR]):
                raise AssertionError("pipeline %s mismatch" % decoder)
            t = timed(lambda: fn(*args), reps)
            dev = jax.devices()[0]
            mem = dev.memory_stats() or {}
            emit(phase='pipeline', decoder=decoder, chunks=B,
                 groups=sum(len(p['groups']) for p in parsed),
                 seconds=t, raw_gbps=B * SR * C * 2 / t / 1e9,
                 peak_bytes=mem.get('peak_bytes_in_use'), card=card())
        pipeline.DECODER = None


def phase_ops(r, arr, B, reps):
    import jax
    import jax.numpy as jnp
    from mtscomp_tpu.models import rans
    from mtscomp_tpu.ops import device_rans, device_delta, device_hist
    parsed, groups, states, words, freqs, counts, S = group_arrays(r, B)
    N = len(groups)
    fq = jnp.asarray(freqs)
    # Encode scan + compaction on the decoded rows (bit-exact check
    # against the containers' own streams).
    cum, s2s = device_rans.derive_tables(fq)
    ref, _ = device_rans.decode_groups(
        jnp.asarray(states), jnp.asarray(words), fq, jnp.asarray(counts),
        n_steps=S)
    sy = jnp.transpose(ref, (0, 2, 1, 3)).reshape(N, 32, S * 128)
    # Zero the symbols past each row's count (the encoder ignores them,
    # but keep inputs deterministic).
    col = jnp.arange(S * 128)[None, None, :]
    sy = jnp.where(col < jnp.asarray(counts)[:, :, None], sy, 0)
    pk, rcp = rans.encoder_tables(freqs)
    pk, rcp, ct = jnp.asarray(pk), jnp.asarray(rcp), jnp.asarray(counts)
    w_bound = max(g['words'].size for g in groups)

    @jax.jit
    def enc(sy, pk, rcp, ct):
        st, wd, em = device_rans.encode_groups(sy, pk, rcp, ct, n_steps=S)
        streams, nw = device_rans.compact_words(wd, em, w_bound)
        return st, streams, nw
    st, streams, nw = enc(sy, pk, rcp, ct)
    st, streams, nw = (np.asarray(a) for a in (st, streams, nw))
    for i, g in enumerate(groups):
        R = len(g['segments'])
        assert np.array_equal(st[i, :R], g['states'])
        assert nw[i] == g['words'].size
        assert np.array_equal(streams[i, :nw[i]], g['words'])
    emit(phase='ops', op='encode_scan+compact', chunks=B, groups=N,
         seconds=timed(lambda: enc(sy, pk, rcp, ct), reps), card=card())

    # Table derivation.
    f = jax.jit(device_rans.derive_tables)
    assert np.array_equal(np.asarray(f(fq)[1]), np.asarray(s2s))
    emit(phase='ops', op='derive_tables', groups=N,
         seconds=timed(lambda: f(fq), reps), card=card())

    # Inverse time scan on a (B, T, C) chunk batch and its transposed
    # (channel-major) input: plain jnp.cumsum, exactness vs numpy.
    x = arr[:B * SR].reshape(B, SR, C).view(np.int16)
    d = np.diff(x, axis=1, prepend=np.zeros((B, 1, C), np.int16))
    d_d = jnp.asarray(d)
    csum = jax.jit(device_delta.cumsum_time_jnp)
    assert np.array_equal(np.asarray(csum(d_d)), x)
    emit(phase='ops', op='cumsum_time', chunks=B,
         seconds=timed(lambda: csum(d_d), reps), card=card())
    dt_d = jnp.asarray(np.ascontiguousarray(np.transpose(d, (0, 2, 1))))
    tcs = jax.jit(lambda a: device_delta.cumsum_time_jnp(
        jnp.transpose(a, (0, 2, 1))))
    assert np.array_equal(np.asarray(tcs(dt_d)), x)
    emit(phase='ops', op='transpose+cumsum_time', chunks=B,
         seconds=timed(lambda: tcs(dt_d), reps), card=card())

    # Byte histograms: per-plane rows and per-channel rows.
    planes = jnp.asarray(np.ascontiguousarray(
        np.transpose(d, (0, 2, 1))).view(np.uint8).reshape(B * 2, -1))
    chans = jnp.asarray(np.ascontiguousarray(
        np.transpose(d, (0, 2, 1))).view(np.uint8).reshape(B * C * 2, -1))
    hist = jax.jit(device_hist.histogram256)
    for name, v in (('plane_rows', planes), ('channel_rows', chans)):
        vn = np.asarray(v[:4])
        want = np.stack([np.bincount(row, minlength=256) for row in vn])
        assert np.array_equal(np.asarray(hist(v))[:4], want)
        emit(phase='ops', op='histogram256', rows=name,
             shape=list(v.shape), seconds=timed(lambda: hist(v), reps),
             card=card())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--chunks', default='8,32,64')
    p.add_argument('--warps', default='16')
    p.add_argument('--phases', default='decode,pipeline,ops')
    p.add_argument('--reps', type=int, default=5)
    a = p.parse_args(argv)
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print("device_ab.py needs a GPU (found %s)" % dev.platform,
              file=sys.stderr)
        return 2
    emit(device=dev.device_kind, platform=dev.platform,
         count=len(jax.devices()), card=card())
    chunk_list = [int(c) for c in a.chunks.split(',')]
    phases = a.phases.split(',')
    with tempfile.TemporaryDirectory(dir=os.environ.get('TMPDIR')) as tmp:
        t0 = time.perf_counter()
        arr, r = make_file(tmp, max(chunk_list), a.seed)
        emit(phase='setup', seconds=time.perf_counter() - t0)
        runs = {
            'decode': lambda: phase_decode(
                r, chunk_list, a.reps, [int(w) for w in a.warps.split(',')]),
            'pipeline': lambda: phase_pipeline(r, arr, chunk_list, a.reps),
            'ops': lambda: phase_ops(r, arr, chunk_list[0], a.reps),
        }
        try:
            for name in phases:         # in the order given
                runs[name]()
        finally:
            r.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
