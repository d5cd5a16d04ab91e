"""Batched device decode pipeline.

Replaces the reference's ThreadPool-of-chunks decompression
(mtscomp.py:645-650, 686-699) with a device program: a batch of B chunk
containers is parsed on the host, every rANS *group* across the batch is
decoded on the device (:func:`device_coders` picks the GPU kernel in
``ops/gpu_rans.py`` or the XLA scan in ``ops/device_rans.py``),
segments are reassembled into byte planes, planes are combined, zigzag is inverted,
the F-order element stream is reshaped, and the inverse delta scan runs
— all inside ONE jitted function per shape signature, so XLA fuses the
postprocessing and the only host<->device traffic is (compressed payload
in, decoded chunks out).

Shape signatures are (B, T, C, dtype, plane modes, segment geometry,
W-bucket); payload word lengths are padded to multiples of
:data:`WORD_BUCKET` words to bound the number of compilations.
"""

import collections
import functools
import os
from pathlib import Path

import numpy as np

from ..codec.ans import MODE_RAW, MODE_RANS, MODE_CONST
from ..codec.ans import seg_freqs as ans_seg_freqs
from ..models.rans import LANES, GROUP_ROWS, RANS_L
from ..utils.misc import logger
from ..utils.trace import count, phase


_CACHE_SET = False


def compile_cache_dir():
    """Where the persistent compile cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and
    nothing here overrides it); otherwise one fixed directory inside the
    checkout, ``<repo>/.jax_cache`` (gitignored). The path is part of
    the cache key, so it must not move between processes.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / '.jax_cache')


def _jax():
    import jax
    import jax.numpy as jnp
    global _CACHE_SET
    if not _CACHE_SET:
        _CACHE_SET = True
        # Persistent compile cache for every device path: CLI
        # invocations are fresh processes, and the fused decode/encode
        # programs are worth keeping compiled.
        if jax.config.jax_compilation_cache_dir is None:
            jax.config.update('jax_compilation_cache_dir',
                              compile_cache_dir())
            jax.config.update(
                'jax_persistent_cache_min_compile_time_secs', 0.5)
    return jax, jnp


#: Decoder override for A/B measurements and tests. ``None`` picks per
#: platform (:func:`device_coders`); ``'scan'`` or ``'kernel'`` forces
#: one. The kernel on the CPU backend runs in Pallas interpret mode,
#: which only a caller that sets this asks for.
DECODER = None


class Coders(collections.namedtuple(
        'Coders', 'platform decoder encoder interpret')):
    """What the device path runs on this process's JAX platform."""
    __slots__ = ()

    @property
    def host_resident(self):
        """Device arrays live in host memory (JAX's CPU backend): no
        link to pay for when routing."""
        return self.platform == 'cpu'


def device_platform():
    """JAX's default platform ('gpu' or 'cpu'); initializes JAX."""
    jax, _ = _jax()
    return jax.default_backend()


def device_coders():
    """The device path's one backend decision.

    ``gpu``: the grouped rANS decode kernel (``ops/gpu_rans.py``) and
    the XLA encode scan. ``cpu`` (the test suite's backend): the XLA
    scans in both directions. Any other platform has no device path.
    """
    platform = device_platform()
    if platform not in ('gpu', 'cpu'):
        raise RuntimeError("no device path for JAX platform %r" % platform)
    decoder = DECODER or ('kernel' if platform == 'gpu' else 'scan')
    if decoder not in ('kernel', 'scan'):
        raise ValueError("unknown decoder %r" % decoder)
    return Coders(platform, decoder, 'scan',
                  decoder == 'kernel' and platform == 'cpu')


def check_device(device):
    """Raise unless JAX runs on the platform that ``device`` names.

    ``device='gpu'`` never runs on the CPU and ``device='cpu'`` never on
    a GPU: a forced device that is absent is an error, not a fallback.
    """
    platform = device_platform()
    if platform != device:
        raise RuntimeError(
            "device=%r was requested, but JAX runs on %r%s." % (
                device, platform,
                " (no GPU found: check the CUDA plugin, or use "
                "device='auto')" if device == 'gpu' else
                " (set JAX_PLATFORMS=cpu to use the CPU backend)"))


_LINK_PROFILE = None


def link_profile(refresh=False):
    """Measured ``(sync_latency_s, device->host_bytes_per_s)`` of this
    process's accelerator link; cached after the first call.

    Random-access routing (``Reader._use_device``) must know the link,
    because a window read pays one sync plus the window download.
    Measured, not configured: a tiny reduction fetch bounds the round
    trip latency and a 256 KB array fetch bounds the device->host
    bandwidth. CPU backends report (0, inf): arrays are host-resident
    already.
    """
    global _LINK_PROFILE
    if _LINK_PROFILE is not None and not refresh:
        return _LINK_PROFILE
    jax, jnp = _jax()
    # Backend check BEFORE the disk cache: the cache is keyed per
    # machine, but the same machine can run CPU-backend processes
    # (jax_platforms=cpu) right after a GPU run wrote its profile —
    # host-resident arrays must always report (0, inf).
    if device_coders().host_resident:
        _LINK_PROFILE = (0.0, float('inf'))
        return _LINK_PROFILE
    if not refresh:
        cached = _load_link_cache()
        if cached is not None:
            _LINK_PROFILE = cached
            return _LINK_PROFILE
    small = jnp.zeros((8, LANES), jnp.float32)
    float(jnp.sum(small))                   # compile + first-fetch
    lat = min(_timed(lambda: float(jnp.sum(small))) for _ in range(3))
    # The fetch must hit the link every rep: jax.Array caches its host
    # copy after the first materialization, so each rep fetches a FRESH
    # device buffer, xor'd on device so the fetched buffer never
    # aliases the uploaded one.
    payload = np.random.default_rng(0).integers(
        0, 1 << 32, size=(1 << 16,), dtype=np.uint32)     # 256 KB
    fetches = []
    for i in range(2):
        dev = jax.device_put(payload) ^ np.uint32(i + 1)
        fetches.append(_timed(lambda d=dev: np.asarray(d)))
    bw = payload.nbytes / max(min(fetches) - lat, 1e-7)
    _LINK_PROFILE = (lat, bw)
    logger.debug("Accelerator link profile: sync %.2f ms, fetch %.0f MB/s.",
                 lat * 1e3, bw / 1e6)
    _store_link_cache(_LINK_PROFILE)
    return _LINK_PROFILE


_LINK_CACHE_TTL = 24 * 3600.0


def _profile_cache_path(name):
    return os.path.join(os.path.expanduser('~/.cache/mtscomp_tpu'), name)


def _load_profile_cache(name, keys):
    """Probing costs time (a backend init for the link, ~100 ms of
    codec work for the host) — one measured profile serves every
    process on the machine for a day. A stale entry only costs speed,
    never correctness (every route is byte-exact)."""
    import json
    import os
    import time
    try:
        path = _profile_cache_path(name)
        if time.time() - os.stat(path).st_mtime > _LINK_CACHE_TTL:
            return None
        with open(path) as f:
            d = json.load(f)
        return tuple(float(d[k]) for k in keys)
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _store_profile_cache(name, keys, values):
    import json
    import os
    try:
        path = _profile_cache_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(dict(zip(keys, values)), f)
        os.replace(tmp, path)
    except OSError:  # pragma: no cover - cache is best-effort
        pass


_LINK_KEYS = ('latency_s', 'bytes_per_s')


def _load_link_cache():
    return _load_profile_cache('link_profile.json', _LINK_KEYS)


def _store_link_cache(profile):
    _store_profile_cache('link_profile.json', _LINK_KEYS, profile)


_HOST_PROFILE = None
_HOST_KEYS = ('encode_bytes_per_s', 'decode_bytes_per_s')
# Fallbacks if the measurement itself fails (never expected): the
# round-1/2 hardcoded estimates (~300 MB/s native encode, ~250 MB/s
# native decode per core on a commodity core).
_HOST_FALLBACK = (300e6, 250e6)


def host_profile(refresh=False):
    """Measured ``(encode_bytes_per_s, decode_bytes_per_s)`` of ONE
    host core running the ans codec on a synthetic Neuropixels-like
    block; cached in-process and on disk (24 h, beside the link
    profile).

    Auto routing (``Writer._use_device`` / ``Reader._use_device``)
    compares the accelerator link against the host codec; the host
    side was a hardcoded ``300e6 x cores`` guess through round 2 —
    wrong on hosts whose cores aren't ~300 MB/s, and blind to whether
    the native runtime is actually loaded. Measuring a ~4 MB block
    through the real encode/decode entry points (~100 ms with the C++
    runtime, sub-second even on the numpy fallback) makes the decision
    derive from two measurements instead of one measurement and one
    guess.
    """
    global _HOST_PROFILE
    if _HOST_PROFILE is not None and not refresh:
        return _HOST_PROFILE
    if not refresh:
        cached = _load_profile_cache('host_profile.json', _HOST_KEYS)
        if cached is not None:
            _HOST_PROFILE = cached
            return _HOST_PROFILE
    _HOST_PROFILE = _measure_host_rates()
    logger.debug("Host codec profile: encode %.0f MB/s, decode %.0f MB/s "
                 "per core.", _HOST_PROFILE[0] / 1e6,
                 _HOST_PROFILE[1] / 1e6)
    _store_profile_cache('host_profile.json', _HOST_KEYS, _HOST_PROFILE)
    return _HOST_PROFILE


def _measure_host_rates():
    """One-shot single-thread codec rates on a ~4 MB synthetic chunk.

    Times the same entry points the production paths use: encode with
    the fused time-diff prep (Writer._compress_chunk) and decode +
    in-dtype inverse cumsum (Reader.read_chunk). Best of 3 reps — the
    routing decision separates links that differ ~100x, so scheduler
    jitter is immaterial.
    """
    import time
    try:
        from ..codec.ans import AnsCodec
        from ..ops.delta import cumsum_along_axis
        ns, nc = 16384, 128                     # 4 MB int16
        rng = np.random.default_rng(0)
        arr = np.ascontiguousarray(np.cumsum(
            rng.normal(0.0, 6.0, size=(ns, nc)), axis=0).astype(np.int16))
        codec = AnsCodec()
        enc_t = dec_t = float('inf')
        payload = None
        for _ in range(3):
            t0 = time.perf_counter()
            payload = codec.encode(arr, order='F', time_diff_pending=True)
            enc_t = min(enc_t, time.perf_counter() - t0)
        for _ in range(3):
            t0 = time.perf_counter()
            out = codec.decode(payload, ns, nc, arr.dtype, order='F')
            cumsum_along_axis(out, axis=0, inplace=True)
            dec_t = min(dec_t, time.perf_counter() - t0)
        return (arr.nbytes / max(enc_t, 1e-7),
                arr.nbytes / max(dec_t, 1e-7))
    except Exception:  # pragma: no cover - fallback only
        logger.debug("Host codec rate probe failed; using fallback "
                     "estimates.", exc_info=True)
        return _HOST_FALLBACK


def _timed(fn):
    import time
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=32)
def _build_decode_fn(B, T, C, dtype_str, modes, n_seg, seg, G, S, W, order,
                     do_time_diff, do_spatial_diff, zigzag, has_head,
                     aligned=False, diff_order=1, tail_split=1,
                     decoder='scan', shift=0, interpret=False):
    """Compile the fused decode for one shape signature.

    B chunks of (T, C); ``modes`` per-plane; each RANS plane has
    ``n_seg`` segments of ``seg`` symbols; G groups per chunk; step
    count S; word buffers padded to W words. ``aligned``: the container
    uses channel-aligned segments (RANS plane streams are per-channel
    padded to tp = ceil((T-1)/128)*128). ``decoder`` is ``'kernel'``
    (``ops/gpu_rans.py``; ``shift`` sizes its symbol table) or
    ``'scan'`` (``ops/device_rans.py``).
    """
    jax, jnp = _jax()
    from ..ops.device_rans import decode_groups, derive_tables
    from ..ops.gpu_rans import decode_groups_kernel, kernel_tables
    from ..ops.device_delta import (cumsum_time_jnp, cumsum_space_jnp,
                                    zigzag_decode_jnp)

    dtype = np.dtype(dtype_str)
    Tc = T - 1 if has_head else T       # rows covered by the coded planes
    n_elems = Tc * C
    tp = -(-Tc // LANES) * LANES if aligned else 0
    n_stream = C * tp if aligned else n_elems
    rans_planes = [p for p, m in enumerate(modes) if m == MODE_RANS]
    const_planes = [p for p, m in enumerate(modes) if m == MODE_CONST]
    raw_planes = [p for p, m in enumerate(modes) if m == MODE_RAW]
    n_rows = len(rans_planes) * n_seg          # flat segments per chunk
    # Segment payload slice: full segments carry exactly ``seg`` symbols;
    # when the chunk is smaller than one segment, rows only span S*128.
    seg_eff = min(seg, S * LANES) if rans_planes else 0

    @jax.jit
    def decode(states, words, freqs, counts, const_vals, raw_vals, heads):
        ubits = 'uint%d' % (dtype.itemsize * 8)
        acc = jnp.zeros((B, n_elems), dtype=jnp.dtype(ubits))
        used = jnp.zeros((B,), dtype=jnp.int32)
        if rans_planes:
            if decoder == 'kernel':
                cum, slot2sym = derive_tables(freqs)
                fc, sym = kernel_tables(freqs, cum, slot2sym, shift)
                syms, used = decode_groups_kernel(
                    states, words, sym, fc, counts, n_steps=S, shift=shift,
                    interpret=interpret)
                # Row-linear already: (B*G, R, S*128).
                rows = syms.reshape(B, G * GROUP_ROWS, S * LANES)
            else:
                syms, used = decode_groups(states, words, freqs, counts,
                                           n_steps=S)
                # (B*G, S, R, 128) -> (B, G*R rows, S*128)
                rows = syms.reshape(B, G, S, GROUP_ROWS, LANES)
                rows = jnp.transpose(rows, (0, 1, 3, 2, 4))
                rows = rows.reshape(B, G * GROUP_ROWS, S * LANES)
            if tail_split > 1:
                # flags bit6: the flat segment list is non-uniform (the
                # ragged tail is M sub-rows), so the uniform reshape
                # below does not apply — reassemble the plane streams
                # from each row's real symbol range.
                from ..codec.ans import segment_counts as _seg_counts
                seg_list = _seg_counts(n_stream, seg, modes, tail_split)
                planes = jnp.concatenate(
                    [rows[:, r, :n] for r, (_sp, _ss, n)
                     in enumerate(seg_list)], axis=1)
                planes = planes.reshape(B, len(rans_planes), n_stream)
            else:
                rows = rows[:, :n_rows, :seg_eff]
                planes = rows.reshape(B, len(rans_planes),
                                      n_seg * seg_eff)
                planes = planes[:, :, :n_stream]
            if aligned:
                # Drop the per-channel zero pads of the coded streams.
                planes = planes.reshape(
                    B, len(rans_planes), C, tp)[:, :, :, :Tc]
                planes = planes.reshape(B, len(rans_planes), n_elems)
            for j, p in enumerate(rans_planes):
                acc = acc | (planes[:, j, :].astype(ubits) << (8 * p))
        for j, p in enumerate(const_planes):
            acc = acc | (const_vals[:, j:j + 1].astype(ubits) << (8 * p))
        for j, p in enumerate(raw_planes):
            acc = acc | (raw_vals[:, j, :].astype(ubits) << (8 * p))
        if zigzag:
            elems = zigzag_decode_jnp(acc, dtype)
        else:
            elems = acc.astype(dtype)
        if order == 'F':
            chunks = jnp.transpose(elems.reshape(B, C, Tc), (0, 2, 1))
        else:
            chunks = elems.reshape(B, Tc, C)
        if has_head:
            chunks = jnp.concatenate([heads[:, None, :], chunks], axis=1)
        if do_spatial_diff:
            chunks = cumsum_space_jnp(chunks)
        if do_time_diff:
            # In-dtype wrapping scans: exact in any summation order.
            for _ in range(diff_order):
                chunks = cumsum_time_jnp(chunks)
        return chunks, used

    return decode


# Word buffers of a batch round up to a multiple of this many words.
WORD_BUCKET = 1 << 16

#: Raw bytes per automatic device batch (``batch_chunks=0``). The decode
#: kernel runs one program per group (four per 385-channel 1-s chunk),
#: so a batch needs a few times the card's SM count in groups before it
#: fills the card: 2 GiB is 92 such chunks, 368 groups for the H100's
#: 132 SMs, decoded through finalize at 90.4 GB/s against 83.5 GB/s for
#: 1 GiB batches, for 9.4 GB of device memory instead of 4.7 (H100,
#: 700 W limit, tools/device_ab.py).
DEVICE_BATCH_BYTES = 1 << 31


def device_batch_chunks(chunk_bytes, batch_chunks=0, floor=1):
    """Chunks per device batch: ``batch_chunks`` when set, else enough
    chunks for :data:`DEVICE_BATCH_BYTES` (at least ``floor``)."""
    if batch_chunks:
        return int(batch_chunks)
    return max(int(floor), DEVICE_BATCH_BYTES // max(int(chunk_bytes), 1))


def check_words_used(parsed_list, used):
    """Compare device-reported per-group word consumption to the
    containers' stored stream lengths; IOError on mismatch."""
    n_groups = sum(len(p['groups']) for p in parsed_list)
    if n_groups == 0:
        return
    used = np.asarray(used).reshape(-1)
    i = 0
    for parsed in parsed_list:
        for g in parsed['groups']:
            if used[i] != g['words'].size:
                raise IOError("ANS group consumed %d of %d payload words."
                              % (used[i], g['words'].size))
            i += 1


def batch_key(parsed):
    """What chunks of one device decode batch must share: plane modes,
    per-chunk transform (bit5), tail split (bit6) and stream geometry."""
    return (tuple(parsed['modes']), parsed.get('transform'),
            parsed.get('tail_split', 1), parsed['seg'], parsed['aligned'],
            parsed['zigzag'], parsed['n_stream'], parsed['itemsize'],
            parsed['n_head'])


def uniform_runs(parsed_list):
    """``[(start, stop)]`` maximal runs of consecutive equal
    :func:`batch_key` (plane modes are data-dependent per chunk)."""
    runs = []
    for i, p in enumerate(parsed_list):
        k = batch_key(p)
        if runs and runs[-1][2] == k:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1, k])
    return [(a, z) for a, z, _k in runs]


class DeviceBatchDecoder:
    """Decode batches of parsed ANS chunk containers on the device."""

    def __init__(self, reader):
        self.reader = reader
        assert reader.algorithm == 'ans', \
            "device batch decode requires the ans (v2) format"
        # Bitcast float files decode in their integer coding dtype
        # (float16 -> the fused i16 kernels, float32 -> the int32
        # variant); callers reinterpret the decoded buffers back to the
        # reader dtype (same bytes, zero copy).
        self.dtype = np.dtype(getattr(reader, 'code_dtype', reader.dtype))
        self.order = reader.chunk_order
        self.do_time_diff = bool(reader.cmeta.do_time_diff)
        self.do_spatial_diff = bool(reader.cmeta.do_spatial_diff)
        self.diff_order = int(getattr(reader, 'time_diff_order', 1))

    def supported(self, parsed_list, n_samples):
        """Uniform geometry/modes across the batch, integer dtype.

        Containers that fail here take the host path, which raises the
        decoders' documented IOErrors for genuinely malformed inputs
        (dtype/itemsize mismatch, foreign head geometry) instead of
        producing wrong bytes or raw broadcast errors.
        """
        if self.dtype.kind not in 'iu':
            return False
        if self.dtype.itemsize > 4:
            # 8-byte dtypes (int64/uint64, and float64 via bitcast)
            # must decode on the host: under JAX's default x64-disabled
            # mode a uint64 plane accumulator silently truncates to
            # uint32, OR-shifting the upper four byte planes into
            # oblivion — wrong values with the wrong dtype, and every
            # payload-level guard (CRC, table validation, word audit)
            # still passes. The host codec is exact for any width
            # (reference semantics, mtscomp.py:143-169, 375-397).
            return False
        if self.dtype.byteorder not in '<=|':
            return False     # JAX has no non-native dtypes; host path
        first = parsed_list[0]
        if first['itemsize'] != self.dtype.itemsize:
            return False
        if first['n_head'] not in (0, self.reader.n_channels):
            return False
        # One compiled decode fn per batch: every chunk must share the
        # signature (callers split mixed spans with uniform_runs).
        key = batch_key(first)
        n_elems = n_samples * self.reader.n_channels
        return all(batch_key(p) == key and p['n_elems'] == n_elems
                   for p in parsed_list)

    def decode_batch(self, parsed_list, n_samples, mesh=None):
        """Returns (B, n_samples, n_channels) decoded ndarray.

        Raises IOError when any group's stream-word consumption differs
        from its container's stored length (corrupt payload) — the
        device analogue of the sequential decoders' inline check.
        """
        with phase('decode.pack'):
            fn, args = self.pack(parsed_list, n_samples, mesh=mesh)
        with phase('decode.device'):
            out, used = fn(*args)
        with phase('decode.fetch'):
            check_words_used(parsed_list, used)
            return np.asarray(out)

    def pack(self, parsed_list, n_samples, mesh=None):
        """Stage a batch: build device arrays + the compiled decode fn.

        Returns ``(fn, device_args)``; ``fn(*device_args)`` decodes
        entirely on-device and returns ``(chunks, words_used)`` — pass
        ``words_used`` to :func:`check_words_used` for the corruption
        audit (decode_batch does). Useful to amortize host->device
        transfer of the compressed batch across repeated decodes.

        With ``mesh`` (a 1-D device mesh), the chunk batch is sharded
        across devices under shard_map — each device decodes its own
        chunks' groups; no cross-chunk communication is needed.
        """
        jax, jnp = _jax()
        B = len(parsed_list)
        C = self.reader.n_channels
        T = n_samples
        n_elems = T * C
        first = parsed_list[0]
        modes = tuple(first['modes'])
        seg = first['seg']
        has_head = first['n_head'] > 0
        n_coded = n_elems - first['n_head']
        n_stream = first['n_stream']
        aligned = first['aligned']
        rans_planes = [p for p, m in enumerate(modes) if m == MODE_RANS]
        const_planes = [p for p, m in enumerate(modes) if m == MODE_CONST]
        raw_planes = [p for p, m in enumerate(modes) if m == MODE_RAW]
        n_seg = -(-n_stream // seg) if rans_planes else 0
        G = len(first['groups'])
        S = -(-min(seg, n_stream) // LANES) if rans_planes else 0
        # Effective transform: adaptive chunks' payload descriptor
        # (batch-uniform, enforced by supported()) overrides the
        # sidecar-derived reader attributes.
        tr = first.get('transform')
        if tr is not None:
            do_time_diff = tr[0] > 0
            diff_order = tr[0] if tr[0] else 1
            do_spatial_diff = bool(tr[1])
        else:
            do_time_diff = self.do_time_diff
            diff_order = self.diff_order
            do_spatial_diff = self.do_spatial_diff

        coders = device_coders()
        count('decode.batches.%s.%s' % (coders.platform, coders.decoder))

        w_max = 1
        for parsed in parsed_list:
            for g in parsed['groups']:
                w_max = max(w_max, g['words'].size)
        # Word buffers bucketed to 64K-word multiples: bounds the number
        # of compiled signatures across batches.
        W = -(-w_max // WORD_BUCKET) * WORD_BUCKET

        NG = max(B * G, 1)
        states = np.full((NG, GROUP_ROWS, LANES), RANS_L, dtype=np.uint32)
        words = np.zeros((NG, W), dtype=np.uint16)
        freqs = np.zeros((NG, GROUP_ROWS, 256), dtype=np.int32)
        counts = np.zeros((NG, GROUP_ROWS), dtype=np.int32)
        const_vals = np.zeros((B, max(len(const_planes), 1)), dtype=np.uint8)
        raw_vals = np.zeros((B, max(len(raw_planes), 1),
                             n_coded if raw_planes else 1), dtype=np.uint8)
        heads = np.zeros((B, C), dtype=self.dtype)
        table_cache = {}

        def table(parsed, p, start):
            # Key on the table CONTENT: identical tables across chunks
            # (the common case) resolve once per batch.
            t = ans_seg_freqs(parsed, p, start)
            return table_cache.setdefault(t.tobytes(), t)

        for b, parsed in enumerate(parsed_list):
            if has_head:
                heads[b] = parsed['head'].view(self.dtype)
            for gi, g in enumerate(parsed['groups']):
                i = b * G + gi
                R = len(g['segments'])
                states[i, :R] = g['states']
                words[i, :g['words'].size] = g['words']
                for r, (p, start, n) in enumerate(g['segments']):
                    freqs[i, r] = table(parsed, p, start)
                    counts[i, r] = n
            for j, p in enumerate(const_planes):
                const_vals[b, j] = parsed['planes'][p]['value']
            for j, p in enumerate(raw_planes):
                raw_vals[b, j] = parsed['planes'][p]['raw']

        # Kernel symbol tables keep one entry per 8 slots when every
        # table boundary is a multiple of 8 (all tables this writer
        # emits); foreign min-8 tables get the full 4096-slot table.
        shift = 3 if not any(np.any(t.astype(np.int64) & 7)
                             for t in table_cache.values()) else 0
        raw_args = (states, words, freqs, counts, const_vals, raw_vals,
                    heads)
        if mesh is not None and G == 0:
            # No rANS groups (all planes CONST/RAW): the group arrays
            # have a placeholder leading dim of 1 that cannot shard;
            # plain jit decodes such batches trivially anyway.
            mesh = None
        n_dev = 1 if mesh is None else int(
            np.prod([mesh.shape[a] for a in mesh.axis_names]))
        assert B % n_dev == 0, "chunk batch must divide the mesh"
        fn = _build_decode_fn(
            B // n_dev, T, C, str(self.dtype), modes, n_seg, seg, G, S, W,
            self.order, do_time_diff, do_spatial_diff, first['zigzag'],
            has_head, aligned, diff_order, first.get('tail_split', 1),
            coders.decoder, shift, coders.interpret)
        if mesh is None:
            return fn, tuple(jnp.asarray(a) for a in raw_args)

        # Shard the chunk batch over the mesh: every array's leading dim
        # is chunk-major (B or B*G), so a leading-axis shard keeps whole
        # chunks per device.
        from jax import shard_map
        from jax.sharding import PartitionSpec, NamedSharding
        spec = PartitionSpec(mesh.axis_names[0])
        # pallas_call declares no varying-manifest for its outputs, so
        # the check only runs around the pure-XLA scan.
        fn = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(spec,) * len(raw_args),
            out_specs=(spec, spec), check_vma=coders.decoder == 'scan'))
        sharding = NamedSharding(mesh, spec)
        return fn, tuple(jax.device_put(a, sharding) for a in raw_args)


@functools.lru_cache(maxsize=16)
def _build_transform_fn(B, T, C, dtype_str, order, do_time_diff,
                        do_spatial_diff, split_head, diff_order=1):
    """Device transform stage: diff -> zigzag -> byte planes + histograms."""
    jax, jnp = _jax()
    from ..ops.device_delta import (diff_time_jnp, diff_space_jnp,
                                    zigzag_encode_jnp)
    from ..ops.device_hist import histogram256
    dtype = np.dtype(dtype_str)
    P = dtype.itemsize

    @jax.jit
    def transform(chunks):
        d = chunks
        if do_time_diff:
            for _ in range(diff_order):
                d = diff_time_jnp(d)
        if do_spatial_diff:
            d = diff_space_jnp(d)
        coded = d[:, 1:, :] if split_head else d
        z = zigzag_encode_jnp(coded)
        if order == 'F':
            flat = jnp.transpose(z, (0, 2, 1)).reshape(B, -1)
        else:
            flat = z.reshape(B, -1)
        planes = jnp.stack(
            [(flat >> (8 * p)).astype(jnp.uint8) for p in range(P)], axis=1)
        n = planes.shape[-1]
        hists = histogram256(planes.reshape(B * P, n)).reshape(B, P, 256)
        head = d[:, 0, :] if split_head else None
        return planes, hists, head

    return transform


# Mixed-mode encode batches split into mode-uniform sub-batches; rows
# smaller than this take the host codec (byte-identical) instead of
# compiling tiny device signatures.
MIN_DEVICE_SUBBATCH = 4


class DeviceBatchEncoder:
    """Encode batches of equal-size integer chunks on the device.

    Produces containers byte-identical to the host AnsCodec (the device
    coder is bit-exact against the normative spec). Mirrors the decode
    pipeline: one transform+histogram pass, host-side table
    quantization and mode decisions, then the grouped encode scan.
    """

    def __init__(self, writer, transform=None):
        self.writer = writer
        self.codec = writer.codec
        # Bitcast float writers hand the encoder integer views; code in
        # the coding dtype (float16 -> int16 runs the full device path).
        self.dtype = np.dtype(getattr(writer, 'code_dtype', writer.dtype))
        self.order = writer.chunk_order
        self.do_time_diff = bool(writer.do_time_diff)
        self.do_spatial_diff = bool(writer.do_spatial_diff)
        self.diff_order = int(getattr(writer, 'time_diff_order', 1))
        # Adaptive windows: ``transform=(order, spatial)`` overrides the
        # writer's global transform for this (window-uniform) batch, and
        # every produced container gets the bit5 descriptor stamp —
        # byte-identical to what Writer._compress_chunk's host path
        # writes for the same chunks.
        self.stamp = None
        if transform is not None:
            t_order, t_spatial = transform
            self.do_spatial_diff = bool(t_spatial)
            self.diff_order = t_order if t_order else 1
            self.do_time_diff = self.do_time_diff and t_order > 0
            self.stamp = (t_order if writer.do_time_diff else 0,
                          bool(t_spatial))

    def supported(self, n_samples):
        return (self.dtype.kind in 'iu' and self.dtype.itemsize <= 2
                and self.dtype.byteorder in '<=|'
                and n_samples > 1
                and self.writer.n_channels < 65536)

    def _encode_scan_mesh(self, symbols, freq_arr, counts_arr, S, mesh):
        """Shard the encode scan's group axis over a device mesh.

        Groups are independent (the codec's chunk-parallel axis under
        shard_map, like DeviceBatchDecoder.pack(mesh=...)); the
        compaction runs as plain jit ops over the sharded outputs.
        Returns ``(states, streams, n_words)`` host arrays.
        """
        jax, jnp = _jax()
        from ..models import rans
        from ..ops.device_rans import encode_groups, compact_words
        from jax import shard_map
        from jax.sharding import PartitionSpec, NamedSharding
        N = int(symbols.shape[0])
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad = (-N) % n_dev
        if pad:
            # Inactive filler groups (zero counts, placeholder tables).
            symbols = jnp.pad(symbols, ((0, pad), (0, 0), (0, 0)))
            freq_arr = np.pad(freq_arr, ((0, pad), (0, 0), (0, 0)))
            counts_arr = np.pad(counts_arr, ((0, pad), (0, 0)))
        enc_pk, enc_rcp = rans.encoder_tables(freq_arr)
        axis = mesh.axis_names[0]
        spec = PartitionSpec(axis)
        spec1 = PartitionSpec(None, axis)
        fn = jax.jit(shard_map(
            lambda s, pk, rc, c: encode_groups(s, pk, rc, c, n_steps=S),
            mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(spec, spec1, spec1)))
        sh = NamedSharding(mesh, spec)
        states_d, words_dense, emit = fn(
            jax.device_put(symbols, sh),
            jax.device_put(jnp.asarray(enc_pk), sh),
            jax.device_put(jnp.asarray(enc_rcp), sh),
            jax.device_put(jnp.asarray(counts_arr), sh))
        n_words_d = jnp.sum(emit, axis=(0, 2), dtype=jnp.int32)
        w_bound = max(int(np.asarray(jnp.max(n_words_d))), 1)
        streams_d, nw_d = compact_words(words_dense, emit, w_bound)
        sl = slice(None, N)
        return (np.asarray(states_d)[sl], np.asarray(streams_d)[sl],
                np.asarray(nw_d)[sl])

    def encode_batch(self, chunks, mesh=None):
        """chunks: (B, T, C) ndarray -> list of container payload bytes.

        With ``mesh`` (1-D device mesh), the group axis of the encode
        scan is sharded across devices (chunk-level data parallelism
        over ICI; no cross-group communication).
        """
        import struct
        jax, jnp = _jax()
        from ..codec import ans as ans_mod
        from ..models import rans
        from ..ops.device_rans import encode_groups, compact_words

        B, T, C = chunks.shape
        P = self.dtype.itemsize
        seg = self.codec.seg
        w = self.writer
        transform = _build_transform_fn(
            B, T, C, str(self.dtype), self.order, self.do_time_diff,
            self.do_spatial_diff, True, self.diff_order)
        with phase('encode.transform'):
            planes_d, hists_d, head_d = transform(jnp.asarray(chunks))
        hists = np.asarray(hists_d)
        heads = np.asarray(head_d)
        n_coded = (T - 1) * C

        # Channel-aligned segments (flags bit2): same eligibility rule
        # and geometry as the host codec (AnsCodec.encode).
        aligned = (getattr(self.codec, 'channel_aligned', False)
                   and self.order == 'F' and n_coded > 0)
        if aligned:
            k, seg, tp, tcs, n_stream = ans_mod.aligned_geometry(
                n_coded, C, seg)
        else:
            k = tp = tcs = 0
            n_stream = n_coded
        n_pad = n_stream - n_coded
        seg_mode = getattr(self.codec, 'table_mode', 'plane') == 'segment'
        if seg_mode and not aligned:
            return None    # host codec handles non-aligned clustering

        # Per-channel histograms for segment-table clustering: the
        # F-order plane stream is channel-major, so per-segment
        # histograms are sums of per-channel ones (plus the per-channel
        # zero pads) — bit-identical to the host codec's bincounts.
        ch_hists = None
        if seg_mode and n_stream > seg:
            from ..ops.device_hist import histogram256
            with phase('encode.seghist'):
                ch = histogram256(planes_d.reshape(B * P * C, tcs))
                ch_hists = np.asarray(ch).reshape(B, P, C, 256)
        n_segs = -(-n_stream // seg) if aligned else 0

        def _seg_hists(b, p):
            out = np.empty((n_segs, 256), dtype=np.int64)
            for s in range(n_segs):
                a, z = s * k, min((s + 1) * k, C)
                out[s] = ch_hists[b, p, a:z].sum(axis=0)
                out[s, 0] += (z - a) * (tp - tcs)
            return out

        # Host: tables + per-plane modes (must be uniform across the
        # batch for one device call; callers fall back otherwise).
        # The decision logic is ans_mod.decide_plane — the SAME code
        # the host codec runs, so containers stay byte-identical.
        modes = np.empty((B, P), dtype=np.int64)
        plane_tables = {}
        for b in range(B):
            for p in range(P):
                seg_fn = ((lambda b=b, p=p: _seg_hists(b, p))
                          if ch_hists is not None else None)
                mode, ptables, tidx = ans_mod.decide_plane(
                    hists[b, p], n_pad, n_stream, n_coded, seg,
                    'segment' if seg_mode else 'plane', seg_fn)
                modes[b, p] = mode
                if mode == ans_mod.MODE_RANS:
                    plane_tables[(b, p)] = (ptables, tidx)
        if not (modes == modes[0]).all():
            # Plane modes are data-dependent per chunk (RAW/RANS/CONST
            # decisions near the ratio boundary — common for float
            # mantissa planes). Split into mode-uniform sub-batches and
            # encode each on device rather than abandoning the batch;
            # decide_plane is deterministic, so each sub-batch passes
            # the uniformity check on re-entry. Sub-batches below
            # MIN_DEVICE_SUBBATCH chunks go to the host codec instead
            # (byte-identical by the cross-implementation invariant):
            # a pathological batch with B distinct mode rows would
            # otherwise compile B one-chunk device signatures, thrashing
            # the lru_cached builders.
            payloads = [None] * B
            for row in sorted({tuple(m) for m in modes.tolist()}):
                ids = [b for b in range(B) if tuple(modes[b]) == row]
                if len(ids) < MIN_DEVICE_SUBBATCH:
                    enc_one = getattr(self.codec, 'encode', None)
                    count('encode.host_chunks', len(ids))
                    for b in ids:
                        payloads[b] = enc_one(
                            self.writer._transform_chunk(
                                chunks[b], self.diff_order,
                                self.do_spatial_diff),
                            order=self.order, transform=self.stamp)
                    continue
                sub = self.encode_batch(np.ascontiguousarray(chunks[ids]),
                                        mesh=mesh)
                if sub is None:  # pragma: no cover - sub-batch declined
                    return None
                for j, b in enumerate(ids):
                    payloads[b] = sub[j]
            return payloads
        mode_row = [int(m) for m in modes[0]]
        rans_planes = [p for p, m in enumerate(mode_row)
                       if m == ans_mod.MODE_RANS]
        raw_planes = [p for p, m in enumerate(mode_row)
                      if m == ans_mod.MODE_RAW]

        # Ragged-tail segment split (flags bit6): identical decision to
        # the host codec (shared helper) so containers stay
        # byte-identical.
        tsplit = ans_mod.tail_split_for(aligned, mode_row, n_stream, seg)

        group_words, group_states, group_counts = [], [], []
        if rans_planes:
            n_seg = -(-n_stream // seg)
            segments = ans_mod.segment_counts(n_stream, seg, mode_row,
                                              tail_split=tsplit)
            G = -(-len(segments) // rans.GROUP_ROWS)
            R = rans.GROUP_ROWS
            S = -(-min(seg, n_stream) // rans.LANES)
            seg_eff = S * rans.LANES
            # Device: assemble (B*G, R, S*128) symbols from the planes.
            Pr = len(rans_planes)
            n_rows = len(segments)
            pad_rows = G * R - n_rows
            pad_tail = n_seg * seg_eff - n_stream

            @jax.jit
            def gather_symbols(planes):
                sel = planes[:, jnp.asarray(rans_planes), :]
                if aligned:
                    # Pad each channel's stream to tp symbols so the
                    # segment rows are the (C, tp) layout.
                    sel = sel.reshape(B, Pr, C, tcs)
                    sel = jnp.pad(sel, ((0, 0), (0, 0), (0, 0),
                                        (0, tp - tcs)))
                    sel = sel.reshape(B, Pr, n_stream)
                if tsplit > 1:
                    # Non-uniform rows: one seg_eff-padded row per
                    # (start, n) of the flat list (bit6 tails shorter).
                    flat = sel.reshape(B, Pr * n_stream)
                    rows = jnp.stack(
                        [jnp.pad(
                            flat[:, rans_planes.index(p) * n_stream
                                 + start:
                                 rans_planes.index(p) * n_stream
                                 + start + n],
                            ((0, 0), (0, seg_eff - n)))
                         for p, start, n in segments], axis=1)
                else:
                    sel = jnp.pad(sel, ((0, 0), (0, 0), (0, pad_tail)))
                    rows = sel.reshape(B, Pr * n_seg, seg_eff)
                rows = jnp.pad(rows, ((0, 0), (0, pad_rows), (0, 0)))
                return rows.reshape(B * G, R, seg_eff)

            symbols = gather_symbols(planes_d)
            freq_arr = np.zeros((B * G, R, 256), dtype=np.int32)
            counts_arr = np.zeros((B * G, R), dtype=np.int32)
            fallback = rans.quantize_freqs(
                np.array([1, 1] + [0] * 254, dtype=np.int64))

            for b in range(B):
                for gi in range(G):
                    i = b * G + gi
                    segs = segments[gi * R:(gi + 1) * R]
                    for r in range(R):
                        if r < len(segs):
                            p, start, n = segs[r]
                            ptables, tidx = plane_tables[(b, p)]
                            freq_arr[i, r] = ptables[
                                0 if tidx is None else tidx[start // seg]]
                            counts_arr[i, r] = n
                        else:
                            freq_arr[i, r] = fallback
            if mesh is not None:
                states, streams, n_words = self._encode_scan_mesh(
                    symbols, freq_arr, counts_arr, S, mesh)
            else:
                enc_pk, enc_rcp = rans.encoder_tables(freq_arr)
                args = (symbols, jnp.asarray(enc_pk), jnp.asarray(enc_rcp),
                        jnp.asarray(counts_arr))
                with phase('encode.scan'):
                    states_d, words_dense, emit = encode_groups(
                        *args, n_steps=S)
                    n_words_d = jnp.sum(emit, axis=(0, 2), dtype=jnp.int32)
                    w_bound = max(int(np.asarray(jnp.max(n_words_d))), 1)
                with phase('encode.compact'):
                    streams_d, nw_d = compact_words(words_dense, emit,
                                                    w_bound)
                    states = np.asarray(states_d)
                    streams = np.asarray(streams_d)
                    n_words = np.asarray(nw_d)
                # Staged device-resident run, kept for benchmarks: the
                # encode analogue of DeviceBatchDecoder.pack.
                self.last_staged = (_build_encode_fn(S, w_bound), args)
            for b in range(B):
                gw, gs, gc = [], [], []
                for gi in range(G):
                    i = b * G + gi
                    segs = segments[gi * R:(gi + 1) * R]
                    gw.append(streams[i, :n_words[i]])
                    gs.append(states[i, :len(segs)])
                    gc.append(int(n_words[i]))
                group_words.append(gw)
                group_states.append(gs)
                group_counts.append(gc)

        planes_np = None
        if raw_planes:
            planes_np = np.asarray(planes_d)

        # Host: assemble containers (identical layout to AnsCodec.encode).
        count('encode.device_chunks', B)
        payloads = []
        for b in range(B):
            multitable = any(
                plane_tables[(b, p)][1] is not None
                for p in rans_planes)
            flags = (1 | 2 | (4 if aligned else 0)
                     | (ans_mod.FLAG_MULTITABLE if multitable else 0)
                     | ans_mod.FLAG_CRC32)
            tdesc = 0
            if self.stamp is not None:
                flags |= ans_mod.FLAG_TRANSFORM
                tdesc = self.stamp[0] | (4 if self.stamp[1] else 0)
            if tsplit > 1:
                flags |= ans_mod.FLAG_TAILSPLIT
            parts = [ans_mod._HEADER.pack(
                ans_mod.MAGIC, ans_mod.CONTAINER_VERSION, P,
                flags, rans.SCALE_BITS, T * C,
                k if aligned else self.codec.seg_log2,
                rans.MIN_FREQ, rans.GROUP_ROWS, tdesc, C,
                tsplit if tsplit > 1 else 0)]
            parts.append(np.ascontiguousarray(heads[b]).tobytes())
            for p in range(P):
                m = mode_row[p]
                if m == ans_mod.MODE_CONST:
                    # The constant byte: derive from the histogram.
                    v = int(np.argmax(hists[b, p]))
                    parts.append(struct.pack('<BB', m, v))
                elif m == ans_mod.MODE_RAW:
                    parts.append(struct.pack('<B', m)
                                 + planes_np[b, p].tobytes())
                else:
                    ptables, tidx = plane_tables[(b, p)]
                    if multitable:
                        meta = (struct.pack('<BB', m, ptables.shape[0])
                                + ptables.astype('<u2').tobytes())
                        if ptables.shape[0] > 1:
                            meta += tidx.tobytes()
                        parts.append(meta)
                    else:
                        parts.append(struct.pack('<B', m)
                                     + ptables[0].astype('<u2').tobytes())
            if rans_planes:
                parts.append(struct.pack('<I', len(group_words[b])))
                parts.append(np.asarray(group_counts[b], '<u4').tobytes())
                for st, wd in zip(group_states[b], group_words[b]):
                    parts.append(st.astype('<u4').tobytes())
                    parts.append(wd.astype('<u2').tobytes())
            payloads.append(ans_mod._append_crc(parts))
        return payloads


class DeviceChunkCache:
    """Random-access acceleration: decoded chunks cached on the device.

    ``read_window`` decodes the covering chunk(s) on the device (one
    chunk per call signature, so compiles are reused), keeps the decoded
    arrays device-resident in a small LRU, slices on device and only
    downloads the requested window — the analogue of the reference's
    host-side LRU chunk cache (mtscomp.py:582-588) with the decode and
    the slicing moved on-chip.
    """

    def __init__(self, reader, capacity=None):
        self.reader = reader
        self.capacity = capacity or reader.cache_size
        self._cache = {}          # chunk_idx -> device array (ns, C)
        self._order = []

    def _chunk(self, idx):
        if idx in self._cache:
            self._order.remove(idx)
            self._order.append(idx)
            return self._cache[idx]
        r = self.reader
        ns = r.chunk_bounds[idx + 1] - r.chunk_bounds[idx]
        parsed = [r.codec.parse(_read_payload(r, idx))]
        dec = DeviceBatchDecoder(r)
        if not dec.supported(parsed, ns):
            # e.g. 8-byte dtypes; Reader._device_window catches this
            # and serves the window through the (exact) host path.
            raise NotImplementedError("unsupported chunk for device cache")
        fn, args = dec.pack(parsed, ns)
        chunks, used = fn(*args)
        check_words_used(parsed, used)
        count('decode.device_chunks')
        out = chunks[0]           # (ns, C), stays on device
        self._cache[idx] = out
        self._order.append(idx)
        while len(self._order) > self.capacity:
            evict = self._order.pop(0)
            del self._cache[evict]
        return out

    def read_window(self, i0, i1):
        """Decoded samples [i0, i1) as a host ndarray."""
        import jax.numpy as jnp
        r = self.reader
        first, last = r._chunks_for_interval(i0, max(i0, i1 - 1))
        parts = []
        for idx in range(first, last + 1):
            c0, c1 = r.chunk_bounds[idx], r.chunk_bounds[idx + 1]
            a = max(i0, c0) - c0
            b = min(i1, c1) - c0
            parts.append(self._chunk(idx)[a:b])
        dev = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        # np.array (not asarray): the download must be a fresh writable
        # host array, never a read-only view of cached device memory
        # (reference windows are writable, mtscomp.py:815-831).
        return _as_user_dtype(np.array(dev), r)


@functools.lru_cache(maxsize=4)
def _build_encode_fn(n_steps, w_bound):
    """Encode scan + compaction as one program (staged benchmark runs)."""
    jax, _ = _jax()
    from ..ops.device_rans import encode_groups, compact_words

    @jax.jit
    def encode(symbols, enc_pk, enc_rcp, counts):
        states, words_dense, emit = encode_groups(
            symbols, enc_pk, enc_rcp, counts, n_steps=n_steps)
        streams, n_words = compact_words(words_dense, emit, w_bound)
        return states, streams, n_words

    return encode


def decompress_to_array(reader, first_chunk=0, last_chunk=None, out=None,
                        writable=True):
    """Bulk-decode chunks [first, last] to one array via the device path.

    Decodes straight into one span-wide destination (``out`` if given,
    else allocated here) — a batch's device output is chunk-major, so a
    whole group lands with ONE reshape/copy and the old per-chunk view
    list + full-span ``np.concatenate`` copy is gone. With
    ``writable=False`` (bulk consumers that only read the result, e.g.
    ``tofile``) a single-uniform-batch span returns the fetched device
    buffer itself (read-only, zero extra copies). Mirrors the host bulk
    path's ``outs=`` span-destination contract
    (``Reader._read_span_bulk``).

    Falls back to the host codec for chunk groups the device path cannot
    batch (mixed plane modes, 8-byte dtypes, foreign geometry).
    """
    last_chunk = reader.n_chunks - 1 if last_chunk is None else last_chunk
    bounds = reader.chunk_bounds
    C = reader.n_channels
    total = bounds[last_chunk + 1] - bounds[first_chunk]
    if out is not None:
        assert out.shape == (total, C) and out.dtype == reader.dtype
    def _peek_desc(idx):
        # Batches must be uniform in the per-chunk transform (flags
        # bit5) and the tail-split derivation (bit6 — data-dependent
        # plane modes can flip it between chunks), so runs split at
        # those boundaries — each uniform run still rides the device
        # path instead of the whole span falling back to host.
        # 20-byte header pread only.
        if reader.algorithm != 'ans':
            return None
        from ..codec.ans import peek_desc
        from ..io_host import pread_exact
        start = reader.chunk_offsets[idx]
        length = min(20, reader.chunk_offsets[idx + 1] - start)
        return peek_desc(pread_exact(reader.cdata, length, start))

    groups = []
    for idx in range(first_chunk, last_chunk + 1):
        ns = bounds[idx + 1] - bounds[idx]
        key = (ns, _peek_desc(idx))
        if groups and groups[-1][1] == key:
            groups[-1][0].append(idx)
        else:
            groups.append(([idx], key))
    pos = 0
    for chunk_ids, (ns, _desc) in groups:
        parsed, runs = None, [(0, len(chunk_ids))]
        if reader.algorithm == 'ans':
            # Only the v2 container has a parse()/device decoder; zlib
            # readers (e.g. legacy probes handed to decompress_multi)
            # go straight to the host branch below. Plane modes are
            # data-dependent per chunk, so the group splits into runs
            # that each share one compiled signature.
            parsed = [reader.codec.parse(_read_payload(reader, i))
                      for i in chunk_ids]
            runs = uniform_runs(parsed)
        dec = DeviceBatchDecoder(reader) if parsed else None
        for a, z in runs:
            ids = chunk_ids[a:z]
            n_span = len(ids) * ns
            if dec is not None and dec.supported(parsed[a:z], ns):
                count('decode.device_chunks', len(ids))
                block = dec.decode_batch(parsed[a:z], ns)   # (B, ns, C)
                if (out is None and len(groups) == 1 and len(runs) == 1
                        and not writable):
                    # The fetched batch is chunk-major: the span IS its
                    # flat view — no destination copy at all.
                    return _as_user_dtype(block.reshape(total, C), reader)
                if out is None:
                    out = np.empty((total, C), reader.dtype)
                np.copyto(out[pos:pos + n_span],
                          _as_user_dtype(block.reshape(n_span, C), reader))
            else:
                logger.debug("Device decode unsupported for chunks %s; "
                             "using host path.", ids)
                count('decode.host_chunks', len(ids))
                if out is None:
                    out = np.empty((total, C), reader.dtype)
                for j, i in enumerate(ids):
                    np.copyto(out[pos + j * ns:pos + (j + 1) * ns],
                              reader._decompress_chunk(i)[1])
            pos += n_span
    return out


def _read_payload(reader, idx):
    from ..io_host import pread_exact
    start = reader.chunk_offsets[idx]
    length = reader.chunk_offsets[idx + 1] - start
    return pread_exact(reader.cdata, length, start)


def _as_user_dtype(arr, reader):
    """Reinterpret device-decoded buffers (coding dtype) as the user
    dtype — a zero-copy view; only differs for bitcast float files."""
    if getattr(reader, 'float_bitcast', False):
        return arr.view(reader.dtype)
    return arr


def decompress_multi(readers, mesh=None, first_chunk=0, last_chunk=None):
    """Decode the same chunk range of several recordings (multi-probe).

    The probes' chunk batches are concatenated and decoded in one device
    call — optionally sharded across a mesh (BASELINE config 4: N probes
    chunk-parallel across chips). All probes must share geometry
    (channels, chunk sizes, dtype, plane modes). Returns a list of
    ``(n_samples, n_channels)`` arrays, one per reader.

    Falls back to per-reader :func:`decompress_to_array` when the
    batches cannot be merged.
    """
    assert readers
    last = readers[0].n_chunks - 1 if last_chunk is None else last_chunk
    n_chunks = last - first_chunk + 1
    if not 0 <= first_chunk <= last:
        raise ValueError(
            "decompress_multi: invalid chunk range [%d, %d]"
            % (first_chunk, last))
    for k, r in enumerate(readers):
        # One COMMON chunk range per call is the contract (the batch is
        # reshaped (n_readers, n_chunks*ns)); a shorter probe would
        # previously surface as a raw IndexError from the fallback.
        if r.n_chunks <= last:
            raise ValueError(
                "decompress_multi decodes one common chunk range, but "
                "reader %d has %d chunks and chunks [%d, %d] were "
                "requested — pass last_chunk to restrict the range."
                % (k, r.n_chunks, first_chunk, last))
    parsed_all, ns = [], None
    r0 = readers[0]
    # Probes must agree on everything the decoder derives from
    # readers[0] — the FULL decode identity (incl. the v2 sidecar
    # extensions time_diff_order/float_bitcast, which supported() can
    # never see: they are sidecar-only, not in the chunk payloads).
    # A mismatch would decode the other probes with the wrong
    # metadata. Fallback, never corrupt.
    from ..format import decode_identity
    ident0 = decode_identity(r0.cmeta)
    mergeable = all(
        r.algorithm == 'ans'
        and decode_identity(r.cmeta) == ident0
        for r in readers)
    if mergeable:
        for r in readers:
            bounds = r.chunk_bounds
            sizes = {bounds[i + 1] - bounds[i]
                     for i in range(first_chunk, last + 1)}
            if len(sizes) != 1 or (ns is not None and sizes != {ns}):
                mergeable = False
                break
            ns = sizes.pop()
            parsed_all.extend(r.codec.parse(_read_payload(r, i))
                              for i in range(first_chunk, last + 1))
    if mergeable:
        dec = DeviceBatchDecoder(readers[0])
        if dec.supported(parsed_all, ns):
            count('decode.device_chunks', len(parsed_all))
            out = _as_user_dtype(dec.decode_batch(parsed_all, ns, mesh=mesh),
                                 r0)
            per = out.reshape(len(readers), n_chunks * ns, -1)
            return [per[i] for i in range(len(readers))]
    return [decompress_to_array(r, first_chunk, last)
            for r in readers]
