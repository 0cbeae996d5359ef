/* Delta-Rice chunk codec (native interop path).
 *
 * Fresh C implementation of the Delta-Rice bitstream for HDF5 filter ID
 * 32025, written against the format spec (see SURVEY.md §7 "format
 * contract"; behavioral reference: /root/reference/src/deltaRice.c). This
 * is the CPU fallback used by third-party HDF5 applications; the device
 * framework itself never calls it.
 *
 * Architecture differs from the reference deliberately: compression is
 * two-phase (exact size-count pass, then parallel pack into the final
 * buffer at prefix-summed offsets), which removes the reference's scratch
 * buffer, its serial compaction memcpy, and its under-sized-scratch
 * overflow for tiny chunks.
 */
#ifndef DR_CODEC_H
#define DR_CODEC_H

#include <stddef.h>
#include <stdint.h>

#define DR_FILTER_ID 32025
#define DR_ESCAPE_Q 8
#define DR_ESCAPE_BITS 25

typedef struct {
  uint32_t m;          /* Rice parameter (power of two) */
  int k;               /* log2(m) */
  int64_t seg_len;     /* samples per segment; -1 = whole chunk */
  int32_t *filt;       /* pre-filter taps (heap) */
  size_t filt_len;
} dr_config;

/* Parse cd_values (schema: [], [M], [M,L], [M,L,nf,f...]). Returns 0 or -1.
 * Caller frees cfg->filt. */
int dr_config_parse(size_t cd_nelmts, const unsigned *cd_values,
                    dr_config *cfg);
void dr_config_free(dr_config *cfg);

/* Compress n int16 samples into a malloc'd framed stream.
 * On success *out / *out_words hold the result (caller frees). */
int dr_compress(const int16_t *samples, size_t n, const dr_config *cfg,
                uint32_t **out, size_t *out_words);

/* Decompress a framed stream of n_words uint32 words into a malloc'd
 * int16 array of *out_n samples. */
int dr_decompress(const uint32_t *words, size_t n_words,
                  const dr_config *cfg, int16_t **out, size_t *out_n);

/* Bit-concatenate per-sub-block packed word streams (rows x parts x w_in)
 * into caller-zeroed output rows (rows x w_out); nbits gives each
 * sub-stream's exact bit length. OpenMP-parallel over rows. */
void dr_merge_substreams(const uint32_t *words, size_t rows, size_t parts,
                         size_t w_in, const int64_t *nbits, size_t w_out,
                         uint32_t *out);

#endif /* DR_CODEC_H */
