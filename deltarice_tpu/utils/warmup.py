"""Cold-start control: pre-compile the codec's device programs.

The reference C filter has zero warm-up; here the first use of a
production shape compiles its programs. The persistent compilation
cache (:mod:`.cache`) makes every LATER process warm — this module fixes the FIRST one: run
``deltarice_tpu.warmup(...)`` (or ``deltarice-tpu warmup``) once at
deploy time, e.g. from the install pipeline, and the cache is populated
before production traffic arrives.

Compile keys are (geometry, Rice parameters, word-bucket): the decode
program is specialized to the 256-word-bucketed compressed width, so the
warmup encodes REPRESENTATIVE data (caller-provided, or a profile's
synthetic generator) and decodes what it produced — zeros would compile
a uselessly small decode bucket. Neighboring word buckets are warmed too
so production data whose ratio wobbles around the sample's stays warm.
"""

from __future__ import annotations

import time

import numpy as np

from ..config import RiceConfig


def warmup(data=None, cfg: RiceConfig | None = None, nseg: int = 1024,
           extra_buckets: int = 1, verbose: bool = False) -> float:
    """Compile encode + decode for one production geometry; returns
    elapsed seconds.

    Args:
      data: representative (num_segments, L) int16 array. Default: the
        Nab profile's synthetic generator at (nseg, cfg length).
      cfg: codec parameters; default Nab (M=8, L=7000).
      nseg: segments per batch when synthesizing data.
      extra_buckets: also warm decode for this many 256-word buckets on
        each side of the sample's, absorbing ratio wobble.
    """
    import jax.numpy as jnp

    from .. import codec

    if cfg is None:
        cfg = RiceConfig(8, 7000)
    if data is None:
        from ..models.profiles import get_profile

        nseg_, length, _ = cfg.segments(
            nseg * (cfg.waveform_length if cfg.waveform_length > 0 else 7000)
        )
        data = get_profile("nab").synthetic(nseg_, length=length)
    data = np.ascontiguousarray(data, dtype=np.int16)
    t0 = time.perf_counter()
    blob = codec.compress(data, cfg)  # encode program (+ split variant)
    out = codec.decompress(blob, cfg)  # decode program at the data's bucket
    assert np.array_equal(out.reshape(data.shape), data)
    # neighboring word buckets: re-frame with padded word counts so the
    # decode compiles for adjacent compressed widths too
    buf = np.frombuffer(blob, dtype="<u4")
    nseg_, length, _ = cfg.segments(data.size)
    counts, starts = codec.walk_headers(buf, nseg_)
    base = -(-(int(counts.max(initial=0)) + 1) // codec._WORD_BUCKET)
    for b in range(1, max(extra_buckets, 0) + 1):
        bucket = (base + b) * codec._WORD_BUCKET
        words = codec.gather_segments(buf, counts, starts, bucket)
        codec.decode_segments(jnp.asarray(words), length, cfg)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"deltarice_tpu warmup: {data.shape} M={cfg.m} "
              f"in {dt:.1f}s (persistent cache now holds the programs)")
    return dt
