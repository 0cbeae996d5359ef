"""Chunk-level Delta-Rice codec: segmentation, device encode/decode, and the
framed byte-stream layout.

Frame layout (frozen; ``writeWholeCompressedByteString`` /
``readWholeCompressedByteString``, ``/root/reference/src/deltaRice.c:383,301``):

    u32 totalSamples | { u32 nWords_i | u32 words_i[nWords_i] } x numSegments

with ``numSegments = ceil(totalSamples / L)`` and the last segment holding the
leftover samples; ``L == -1`` means one segment spanning the chunk. Words are
little-endian uint32 on disk.

Split of responsibilities:

* device (jitted): pre-filter, zigzag, codeword math, bit packing/unpacking —
  everything O(samples), batched over the segment axis (the reference's
  OpenMP ``parallel for`` becomes one GPU thread per segment, or the
  vectorized leading axis of the XLA path).
* host (numpy / native C): the variable-length framing — a ragged
  gather/scatter at memcpy speed, the analog of the reference's serial
  compaction memcpy (``src/deltaRice.c:427-432``) and header walk
  (``:319-325``).

Which device implementation runs is decided in one place,
:func:`deltarice_tpu.backend.resolve`: the GPU kernels on a GPU, the XLA
path on a CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .backend import KERNEL, resolve
from .config import RiceConfig
from .ops.prefilter import prefilter_decode, prefilter_encode
from .ops.rice import codeword_lengths_values, unzigzag, zigzag
from .ops.pack_xla import pack_bits, unpack_bits
from .utils.cache import enable_persistent_cache

_WORD_BUCKET = 256  # decode pads segment word counts up to a multiple of this
                    # to bound the number of distinct compiled shapes


def _encode_path(method: str) -> str:
    enable_persistent_cache()
    return resolve(method, "segsum")


def _decode_path(backend: str) -> str:
    enable_persistent_cache()
    return resolve(backend, "scan")


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 6))
def _encode_segments_xla(x: jnp.ndarray, nvalid: jnp.ndarray,
                         cfg: RiceConfig, max_words: int,
                         method: str = "segsum", prev0=None,
                         prefiltered: bool = False):
    """Pure-XLA encode path (prefix-sum + boundary-gather packing).

    Shape-agnostic and correct everywhere: the CPU path and the GPU
    kernel's reference. Returns (words, nwords, nbits).
    """
    d = x.astype(jnp.int16) if prefiltered else prefilter_encode(
        x, cfg.filt, prev0
    )
    u = zigzag(d)
    lens, vals = codeword_lengths_values(u, cfg.k)
    mask = jnp.arange(x.shape[-1], dtype=jnp.int32)[None, :] < nvalid[:, None]
    lens = jnp.where(mask, lens, 0)
    words, nwords = pack_bits(lens, vals, max_words, method)
    return words, nwords, jnp.sum(lens, axis=-1)


def encode_segments(x: jnp.ndarray, nvalid: jnp.ndarray, cfg: RiceConfig,
                    max_words: int, method: str = "auto"):
    """Encode padded segments.

    Args:
      x: (num_segments, L) int16, zero-padded past each segment's nvalid.
      nvalid: (num_segments,) int32 valid sample counts.
      cfg: codec parameters (static).
      max_words: static packed-words bound, >= cfg.max_words(L).
      method: "pallas" (GPU kernel), "segsum"/"scatter" (XLA), or "auto"
        (see :func:`deltarice_tpu.backend.resolve`).

    Returns:
      (words (num_segments, max_words) uint32, nwords (num_segments,) int32)
    """
    words, nwords, _ = encode_segments_bits(x, nvalid, cfg, max_words,
                                            method)
    return words, nwords


def encode_segments_bits(x: jnp.ndarray, nvalid: jnp.ndarray,
                         cfg: RiceConfig, max_words: int,
                         method: str = "auto", prev0=None,
                         prefiltered: bool = False):
    """:func:`encode_segments` plus exact per-stream bit counts and an
    optional initial delta state — what sub-block-split encoding needs
    (streams concatenate at bit offsets; delta chains continue across
    blocks). ``prefiltered`` skips the pre-filter (the generic-FIR split
    path filters with a halo before splitting). Returns
    (words, nwords, nbits)."""
    method = _encode_path(method)
    if method == KERNEL:
        from .ops.pack_pallas import pack_encode_pallas

        if prefiltered:
            return pack_encode_pallas(x, nvalid, cfg.k, max_words, False)
        if cfg.is_delta:
            return pack_encode_pallas(x, nvalid, cfg.k, max_words, True,
                                      prev0)
        d = prefilter_encode(x, cfg.filt, prev0)
        return pack_encode_pallas(d, nvalid, cfg.k, max_words, False)
    return _encode_segments_xla(x, nvalid, cfg, max_words, method, prev0,
                                prefiltered)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _decode_segments_scan(words: jnp.ndarray, n_samples: int, cfg: RiceConfig):
    """Reference XLA path: per-sample ``lax.scan`` bit cursor (one device
    loop step per sample; shape-agnostic; the CPU path and the GPU
    kernel's reference)."""
    u = unpack_bits(words, n_samples, cfg.k)
    return prefilter_decode(unzigzag(u), cfg.filt)


def _decode_device(words: jnp.ndarray, n_samples: int, cfg: RiceConfig):
    """GPU kernel decode; the generic-FIR inverse runs after it in XLA."""
    from .ops.unpack_pallas import unpack_decode_pallas

    out = unpack_decode_pallas(words, n_samples, cfg.k, cfg.is_delta)
    if not cfg.is_delta:
        out = prefilter_decode(out, cfg.filt)
    return out


def decode_segments(words: jnp.ndarray, n_samples: int, cfg: RiceConfig,
                    backend: str = "auto"):
    """Decode per-segment word streams back to int16 samples.

    words: (num_segments, W) uint32 with at least one zero pad word per row.
    Returns (num_segments, n_samples) int16 (tail of short segments is
    garbage; callers slice by true counts).

    backend: "pallas" (GPU kernel, one thread per segment), "scan" (XLA
    per-sample scan), or "auto" (see :func:`deltarice_tpu.backend.resolve`).
    """
    if _decode_path(backend) == KERNEL:
        return _decode_device(words, n_samples, cfg)
    return _decode_segments_scan(words, n_samples, cfg)


def _segment_layout(total: int, cfg: RiceConfig):
    nseg, length, leftover = cfg.segments(total)
    nvalid = np.full(nseg, length, dtype=np.int32)
    if leftover:
        nvalid[-1] = leftover
    return nseg, length, nvalid


# --- sub-block-split encode for long waveforms -------------------------
#
# A Rice stream is a bit-concatenation of per-sample codewords, and the
# delta filter's only cross-sample state is the previous sample — so a
# long waveform can encode as P independent sub-blocks (each seeded with
# its predecessor's last sample) whose packed sub-streams then
# concatenate at bit offsets, bit-identical to the serial pass. The
# encode kernel runs one thread per stream, so a small batch of long
# segments (NOPTREX: 32 x 500000 per chunk) would otherwise occupy a few
# hundred threads that each walk half a million samples; splitting adds
# threads and shortens the serial walk per thread. The reference has
# no counterpart: its OpenMP parallelism stops at whole waveforms
# (/root/reference/src/deltaRice.c:417-426).
#
# The three thresholds below are inherited from the codec's first,
# lane-parallel design and have not been tuned for a GPU: the split count
# per geometry (e.g. 8,192 encode threads per NOPTREX window) is what
# they give, not a measured optimum.

_SPLIT_MIN_SUB = 8192     # don't split below this sub-block length
_SPLIT_MAX_SUB = 1 << 15  # split longer sub-blocks whatever the fill
_THREAD_TARGET = 1024     # streams per chunk worth filling to


def _split_parts(nseg: int, length: int, cfg: RiceConfig) -> int:
    """Sub-blocks per segment (1 = no split)."""
    if length < 2 * _SPLIT_MIN_SUB:
        return 1
    parts = 1
    # fill the thread target, then keep halving until sub-blocks are short
    while (length // (2 * parts) >= _SPLIT_MIN_SUB
           and (nseg * 2 * parts <= _THREAD_TARGET
                or length // parts >= _SPLIT_MAX_SUB)):
        parts *= 2
    return parts


def _split_layout(padded: np.ndarray, nvalid: np.ndarray, parts: int,
                  halo: int = 0):
    """(rows, L) -> ((rows*parts, halo+Ls), per-sub nvalid, per-sub prev0).

    ``halo`` leading samples per sub-block carry the predecessor's tail
    (zeros for the first block) — what a generic causal FIR pre-filter
    needs to produce the serial pass's outputs at block starts; the
    delta path instead uses ``prev0`` (its entire recurrence state).
    """
    rows, length = padded.shape
    ls = -(-length // parts)
    xp = padded
    if parts * ls != length or halo:
        xp = np.zeros((rows, halo + parts * ls), padded.dtype)
        xp[:, halo : halo + length] = padded
        if halo:
            strided = np.lib.stride_tricks.sliding_window_view(
                xp, halo + ls, axis=1
            )[:, ::ls][:, :parts]
            x3 = strided
        else:
            x3 = xp[:, halo:].reshape(rows, parts, ls)
    else:
        x3 = xp.reshape(rows, parts, ls)
    prev0 = np.zeros((rows, parts), np.int32)
    prev0[:, 1:] = x3[:, :-1, -1]
    nv = np.clip(
        nvalid[:, None] - np.arange(parts, dtype=np.int64)[None, :] * ls,
        0, ls,
    ).astype(np.int32)
    return (np.ascontiguousarray(x3.reshape(rows * parts, halo + ls)),
            nv.reshape(-1), prev0.reshape(-1), ls)


def _encode_split_rows(padded2d: np.ndarray, nvalid_rows: np.ndarray,
                       cfg: RiceConfig, parts: int, method: str):
    """Sub-block-split encode of (rows, L): returns (words, nwords,
    nbits). Delta seeds each block with its predecessor's last sample;
    generic FIR filters each block over a (ntaps-1)-sample halo of
    preceding raw samples — both reproduce the serial filter outputs
    exactly, so the merged stream is byte-identical."""
    if cfg.is_delta:
        xs, nv, p0, ls = _split_layout(padded2d, nvalid_rows, parts)
        return encode_segments_bits(
            jnp.asarray(xs), jnp.asarray(nv), cfg, cfg.max_words(ls),
            method, jnp.asarray(p0),
        )
    halo = len(cfg.filt) - 1
    xs, nv, _p0, ls = _split_layout(padded2d, nvalid_rows, parts, halo)
    d = prefilter_encode(jnp.asarray(xs), cfg.filt)[:, halo:]
    return encode_segments_bits(
        d, jnp.asarray(nv), cfg, cfg.max_words(ls), method,
        prefiltered=True,
    )


def merge_substreams(words3: np.ndarray, nbits2: np.ndarray):
    """Concatenate per-sub-block word streams at bit offsets (host side).

    words3: (rows, P, W) uint32 packed sub-streams, zero beyond each
      stream's words (incl. the final partial word's low bits — the
      packer's zero-fill makes the shifted OR collision-free).
    nbits2: (rows, P) exact bit lengths.

    Returns (merged (rows, max_words) uint32, nwords (rows,) int64) —
    byte-identical to serially encoding each row's full waveform. Runs in
    the native C library (OpenMP) when built; numpy fallback otherwise.
    """
    rows, parts, w_in = words3.shape
    total_bits = nbits2.astype(np.int64).sum(axis=1)
    nwords = (total_bits + 31) >> 5
    maxw = int(nwords.max(initial=0))
    out = np.zeros((rows, maxw + 1), dtype=np.uint32)
    from .native import codec_lib

    lib = codec_lib()
    if lib is not None and hasattr(lib, "dr_merge_substreams"):
        words3 = np.ascontiguousarray(words3)
        nb = np.ascontiguousarray(nbits2, dtype=np.int64)
        lib.dr_merge_substreams(
            words3.ctypes.data, rows, parts, w_in,
            nb.ctypes.data, maxw + 1, out.ctypes.data,
        )
        return out[:, :maxw], nwords
    # vectorized over rows (parts is a short loop): each part's words are
    # shifted by the row's bit phase and OR-placed at its word offset. A
    # row's columns within one part are distinct, so plain fancy |= is
    # collision-free; words beyond a stream's length are zero by the
    # packer's zero-fill, so over-width stores OR zeros (clipped to the
    # scratch column, which is discarded).
    nb64 = nbits2.astype(np.int64)
    base = np.cumsum(nb64, axis=1) - nb64  # (rows, P) start bit offsets
    ridx = np.arange(rows)[:, None]
    for p in range(parts):
        nb_p = nb64[:, p]
        mmax = int(((nb_p.max(initial=0)) + 31) >> 5)
        if mmax == 0:
            continue
        w = words3[:, p, :mmax]
        r = (base[:, p] & 31).astype(np.uint32)[:, None]
        w0 = (base[:, p] >> 5).astype(np.int64)[:, None]
        phase = r != 0
        lo = np.where(phase, w >> r, w)
        hi = np.where(phase, w << ((np.uint32(32) - r) & np.uint32(31)),
                      np.uint32(0))
        cols = w0 + np.arange(mmax, dtype=np.int64)[None, :]
        np.minimum(cols, maxw, out=cols)
        out[ridx, cols] |= lo
        out[ridx, np.minimum(cols + 1, maxw)] |= hi
    return out[:, :maxw], nwords


def compress(data, cfg: RiceConfig = RiceConfig(), method: str = "auto") -> bytes:
    """Compress one chunk of int16 samples to the framed byte stream.

    ``data`` may be an int16 array, any 2-byte-item array (viewed as int16,
    matching the filter's type punning), or raw bytes of even length.
    """
    return compress_batch([data], cfg, method)[0]


def compress_batch(chunks, cfg: RiceConfig = RiceConfig(),
                   method: str = "auto", verify: bool = False,
                   retries: int = 2) -> list[bytes]:
    """Compress many equal-sized chunks in ONE device call.

    The per-chunk :func:`compress` pays one kernel dispatch per chunk;
    batching keeps the device busy across a whole dataset's chunks (the
    reference's "filter called once per chunk" control flow inverted). All
    chunks must have the same sample count (HDF5 chunks always do — edge
    chunks are stored full-size).

    With ``verify=True`` every stream is decoded back on device and
    compared to its input; chunks that fail re-dispatch individually up to
    ``retries`` times (chunks are independent bitstreams, so recovery is
    per-chunk re-dispatch — the failure-handling the reference lacks: its
    filter returns -1 and HDF5 aborts the whole I/O operation,
    ``/root/reference/src/deltaRice.c:474-488``). Persistent failure
    raises ``RuntimeError``.
    """
    handle = compress_batch_dispatch(chunks, cfg, method)
    return compress_batch_collect(handle, cfg, method, verify, retries)


def compress_batch_dispatch(chunks, cfg: RiceConfig = RiceConfig(),
                            method: str = "auto"):
    """Queue the device encode of a chunk batch and return a handle.

    Together with :func:`compress_batch_collect` this splits
    :func:`compress_batch` at the device boundary so callers can overlap
    one window's host-side framing + file I/O with the next window's
    device encode (JAX dispatch is asynchronous; the handle holds
    device-resident arrays). ``collect(dispatch(x)) == compress_batch(x)``
    byte-for-byte.
    """
    arrs = [as_int16(c).ravel() for c in chunks]
    if not arrs:
        return (arrs, 0, None, None, None, 1)
    total = arrs[0].size
    if any(a.size != total for a in arrs):
        raise ValueError("compress_batch requires equal-sized chunks")
    if total == 0:  # header-only streams, matching compress()
        return (arrs, 0, None, None, None, 1)
    nseg, length, nvalid = _segment_layout(total, cfg)
    nchunks = len(arrs)
    padded = np.zeros((nchunks, nseg, length), dtype=np.int16)
    padded.reshape(nchunks, -1)[:, :total] = np.stack(arrs)
    rows2 = padded.reshape(nchunks * nseg, length)
    nv2 = np.tile(nvalid, nchunks)
    parts = _split_parts(nseg, length, cfg)
    if parts > 1:
        words, nwords, nbits = _encode_split_rows(rows2, nv2, cfg, parts,
                                                  method)
        return (arrs, total, words, nwords, nbits, parts)
    words, nwords = encode_segments(
        jnp.asarray(rows2), jnp.asarray(nv2), cfg, cfg.max_words(length),
        method,
    )
    return (arrs, total, words, nwords, None, 1)


def compress_batch_collect(handle, cfg: RiceConfig = RiceConfig(),
                           method: str = "auto", verify: bool = False,
                           retries: int = 2) -> list[bytes]:
    """Fetch + frame the streams of a :func:`compress_batch_dispatch`."""
    arrs, total, words, nwords, nbits, parts = handle
    if not arrs:
        return []
    if total == 0:
        return [np.zeros(1, dtype="<u4").tobytes() for _ in arrs]
    nchunks = len(arrs)
    nseg = _segment_layout(total, cfg)[0]
    # device->host moves ~actual-compressed bytes, not the 25-bit worst
    # case: fetch the (tiny, exact) word counts first, then slice on device
    nw = np.asarray(nwords)
    w = max(int(nw.max(initial=0)), 1)
    merged = np.asarray(words[:, :w])
    if parts > 1:  # concatenate each segment's sub-streams at bit offsets
        rows = nchunks * nseg
        merged, nw = merge_substreams(merged.reshape(rows, parts, w),
                                      np.asarray(nbits).reshape(rows, parts))
    merged = merged.reshape(nchunks, nseg, -1)
    nw = nw.reshape(nchunks, nseg)
    streams = [frame_stream(total, merged[c], nw[c]) for c in range(nchunks)]
    if verify:
        streams = _verify_retry(arrs, streams, cfg, method, retries)
    return streams


def _verify_retry(arrs, streams, cfg: RiceConfig, method: str,
                  retries: int) -> list[bytes]:
    """Round-trip-check every stream; re-dispatch failing chunks.

    One batched decode checks everything; only failing chunks pay the
    per-chunk retry path.
    """
    def bad_indices(idxs, blobs):
        try:
            decoded = decompress_batch(blobs, cfg)
        except ValueError:
            # a corrupted header poisons the whole batch decode; fall back
            # to per-stream checks so only the broken chunk retries
            decoded = []
            for b in blobs:
                try:
                    decoded.append(decompress(b, cfg))
                except ValueError:
                    decoded.append(None)
        return [
            i for i, out in zip(idxs, decoded)
            if out is None or not np.array_equal(out, arrs[i])
        ]

    bad = bad_indices(range(len(streams)), streams)
    for _ in range(max(retries, 0)):
        if not bad:
            break
        for i in bad:
            streams[i] = compress(arrs[i], cfg, method)
        bad = bad_indices(bad, [streams[i] for i in bad])
    if bad:
        raise RuntimeError(
            f"chunks {bad} failed round-trip verification after "
            f"{retries} retries"
        )
    return streams


def decompress_batch(streams, cfg: RiceConfig = RiceConfig(),
                     backend: str = "auto") -> list[np.ndarray]:
    """Decompress many chunks' framed streams in one device call per
    word-count bucket.

    All streams must describe the same sample count (uniform chunks).
    Chunks are grouped by their padded word width so one escape-heavy
    chunk only inflates transfer and compute for its own bucket, not the
    whole batch."""
    return decompress_batch_collect(
        decompress_batch_dispatch(streams, cfg, backend)
    )


def decompress_batch_dispatch(streams, cfg: RiceConfig = RiceConfig(),
                              backend: str = "auto"):
    """Queue the device decode of a stream batch and return a handle.

    The host side (header walk, ragged gather) runs here and each
    word-width bucket's decode is dispatched; the returned handle holds
    device-resident arrays that :func:`decompress_batch_collect` fetches.
    Splitting at the device boundary lets callers overlap one window's
    device->host copy with the next window's file reads + decode
    (JAX dispatch is asynchronous).
    """
    streams = list(streams)
    if not streams:
        return (0, 0, [])
    bufs = [np.frombuffer(memoryview(s), dtype="<u4") for s in streams]
    if any(b.size == 0 for b in bufs):
        raise ValueError("truncated Delta-Rice stream")
    total = int(bufs[0][0])
    if any(int(b[0]) != total for b in bufs):
        raise ValueError("decompress_batch requires equal-sized chunks")
    if total == 0:
        return (len(bufs), 0, [])
    kernel = _decode_path(backend) == KERNEL
    nseg, length, _nvalid = _segment_layout(total, cfg)
    by_bucket: dict[int, list[int]] = {}
    per_chunk = []
    for i, buf in enumerate(bufs):
        counts, starts = walk_headers(buf, nseg)
        per_chunk.append((buf, counts, starts))
        bucket = -(-(int(counts.max(initial=0)) + 1) // _WORD_BUCKET)
        by_bucket.setdefault(bucket * _WORD_BUCKET, []).append(i)
    pending = []
    for bucket, idxs in by_bucket.items():
        words = np.zeros((len(idxs), nseg, bucket), dtype=np.uint32)
        for j, i in enumerate(idxs):
            buf, counts, starts = per_chunk[i]
            words[j] = gather_segments(buf, counts, starts, bucket)
        words2 = jnp.asarray(words.reshape(-1, bucket))
        if kernel:
            dec = _decode_device(words2, length, cfg)
        else:
            dec = _decode_segments_scan(words2, length, cfg)
        pending.append((idxs, dec, nseg * length))
    return (len(bufs), total, pending)


def decompress_batch_collect(handle) -> list[np.ndarray]:
    """Fetch the arrays of a :func:`decompress_batch_dispatch`."""
    n, total, pending = handle
    if total == 0:
        return [np.zeros(0, dtype=np.int16) for _ in range(n)]
    out: list[np.ndarray | None] = [None] * n
    for idxs, dec, flat in pending:
        dec_np = np.asarray(dec).reshape(len(idxs), flat)
        for j, i in enumerate(idxs):
            out[i] = dec_np[j, :total].copy()
    return out


def decompress(stream, cfg: RiceConfig = RiceConfig(),
               backend: str = "auto") -> np.ndarray:
    """Decompress a framed byte stream back to a flat int16 array."""
    return decompress_batch([stream], cfg, backend)[0]


def as_int16(data) -> np.ndarray:
    """View input as int16 samples (the filter compresses raw bytes in
    2-byte units regardless of the declared dtype)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size % 2:
            raise ValueError(f"input size not divisible by two: {arr.size}")
        return arr.view(np.int16)
    arr = np.asarray(data)
    if arr.dtype.itemsize == 2:
        return arr.view(np.int16)
    raw = arr.tobytes()
    if len(raw) % 2:
        raise ValueError(f"input size not divisible by two: {len(raw)}")
    return np.frombuffer(raw, dtype=np.int16)


def frame_stream(total: int, words: np.ndarray, nwords: np.ndarray) -> bytes:
    """Assemble the framed chunk from padded per-segment words (host side).

    Runs in the native C library (OpenMP memcpy per segment — the
    analog of the reference's serial compaction, ``src/deltaRice.c:
    427-432``) when built; the numpy fallback's fancy-index scatter
    costs ~6x more on the same cores and dominated the projected file
    WRITE path before the native routine existed."""
    counts = np.ascontiguousarray(nwords, dtype=np.int64)
    nseg = counts.shape[0]
    word_start = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(counts, out=word_start[1:])
    total_words = int(word_start[-1])
    from .native import codec_lib

    lib = codec_lib()
    if (lib is not None and hasattr(lib, "dr_frame_rows")
            and words.shape[1] >= int(counts.max(initial=0))):
        raw = bytearray(4 * (1 + nseg + total_words))
        out = np.frombuffer(raw, dtype="<u4")
        offsets = 1 + np.arange(nseg, dtype=np.int64) + word_start[:-1]
        words = np.ascontiguousarray(words, dtype=np.uint32)
        lib.dr_frame_rows(
            words.ctypes.data, nseg, words.shape[1],
            counts.ctypes.data, offsets.ctypes.data, total,
            out.ctypes.data,
        )
        return bytes(raw)
    out = np.empty(1 + nseg + total_words, dtype="<u4")
    out[0] = total
    pos = 1 + np.arange(nseg, dtype=np.int64) + word_start[:-1]
    out[pos] = counts
    seg_of = np.repeat(np.arange(nseg, dtype=np.int64), counts)
    within = np.arange(total_words, dtype=np.int64) - np.repeat(word_start[:-1], counts)
    out[np.repeat(pos + 1, counts) + within] = words[seg_of, within]
    return out.tobytes()


def walk_headers(buf: np.ndarray, nseg: int):
    """Serial header walk: per-segment (word count, first-word offset).

    Mirrors the reference's start-location scan (``src/deltaRice.c:319-325``);
    each segment's length header can only be found after the previous one.
    Runs in the native C library when built (many-thousand-chunk reads pay
    this walk serially), with a numpy fallback.
    """
    from .native import codec_lib

    counts = np.empty(nseg, dtype=np.int64)
    starts = np.empty(nseg, dtype=np.int64)
    lib = codec_lib()
    if lib is not None:
        buf = np.ascontiguousarray(buf)
        rc = lib.dr_walk_headers(
            buf.ctypes.data, buf.size, nseg,
            counts.ctypes.data, starts.ctypes.data,
        )
        if rc != 0:
            raise ValueError("truncated Delta-Rice stream")
        return counts, starts
    pos = 1
    for i in range(nseg):
        if pos >= buf.size:
            raise ValueError("truncated Delta-Rice stream")
        starts[i] = pos
        c = int(buf[pos])
        counts[i] = c
        pos += c + 1
    if pos > buf.size:
        raise ValueError("truncated Delta-Rice stream")
    return counts, starts


def gather_segments(buf: np.ndarray, counts: np.ndarray, starts: np.ndarray,
                    bucket: int = _WORD_BUCKET) -> np.ndarray:
    """Scatter the ragged per-segment words into a padded dense matrix
    (native C + OpenMP when built, numpy fallback)."""
    from .native import codec_lib

    nseg = counts.shape[0]
    maxw = int(counts.max(initial=0)) + 1  # +1 pad word for the 64-bit window
    maxw = -(-maxw // bucket) * bucket
    words = np.zeros((nseg, maxw), dtype=np.uint32)
    lib = codec_lib()
    if lib is not None:
        buf = np.ascontiguousarray(buf)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lib.dr_gather_rows(
            buf.ctypes.data, nseg, counts.ctypes.data, starts.ctypes.data,
            maxw, words.ctypes.data,
        )
        return words
    seg_of = np.repeat(np.arange(nseg, dtype=np.int64), counts)
    within = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    words[seg_of, within] = buf[np.repeat(starts + 1, counts) + within]
    return words
