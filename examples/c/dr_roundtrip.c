/* Pure-C HDF5 round-trip through this framework's Delta-Rice filter.
 *
 * Role parity with the reference's C integration example
 * (/root/reference/examples/testCode.c — chunked dataset, cd_values,
 * self-checked read-back), written fresh against this framework's native
 * plugin: the app registers filter 32025 via deltarice_tpu_register()
 * (resolved from the process's own libhdf5), writes a chunked int16
 * dataset through the standard H5Z pipeline, reopens it, and verifies
 * every sample.
 *
 * Build (with HDF5 dev headers):
 *   cc -DDR_HAVE_HDF5_H dr_roundtrip.c -o dr_roundtrip \
 *      ../../deltarice_tpu/native/lib/libh5deltarice_tpu.so -lhdf5
 * Build (runtime-only HDF5, e.g. distro libhdf5_serial):
 *   cc dr_roundtrip.c -o dr_roundtrip \
 *      ../../deltarice_tpu/native/lib/libh5deltarice_tpu.so \
 *      /usr/lib/x86_64-linux-gnu/libhdf5_serial.so.103
 *
 * Run:  ./dr_roundtrip [file.h5]       (prints "deltarice C round-trip OK")
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "dr_hdf5_min.h"

/* from libh5deltarice_tpu.so */
extern int deltarice_tpu_register(void);

#define ROWS 512
#define COLS 1024
#define CHUNK_ROWS 64
#define FILTER_DELTARICE 32025

int main(int argc, char **argv) {
  const char *path = argc > 1 ? argv[1] : "dr_roundtrip.h5";

  static int16_t data[ROWS][COLS], back[ROWS][COLS];
  /* deterministic waveform-ish ramps: smooth per-row cumulative walk */
  for (int r = 0; r < ROWS; r++) {
    int16_t acc = (int16_t)(r - ROWS / 2);
    for (int c = 0; c < COLS; c++) {
      acc = (int16_t)(acc + (int16_t)(((r * 131 + c * 7919) % 13) - 6));
      data[r][c] = acc;
    }
  }

  if (H5open() < 0) return fprintf(stderr, "H5open failed\n"), 1;
  if (deltarice_tpu_register() < 0)
    return fprintf(stderr, "filter registration failed\n"), 1;

  /* --- write ---------------------------------------------------------- */
  hsize_t dims[2] = {ROWS, COLS}, chunk[2] = {CHUNK_ROWS, COLS};
  unsigned cd_values[2] = {8u, COLS}; /* M=8, one waveform per row */

  hid_t f = H5Fcreate(path, H5F_ACC_TRUNC, H5P_DEFAULT, H5P_DEFAULT);
  hid_t space = H5Screate_simple(2, dims, NULL);
  hid_t dcpl = H5Pcreate(H5P_DATASET_CREATE);
  if (f < 0 || space < 0 || dcpl < 0)
    return fprintf(stderr, "create failed\n"), 1;
  if (H5Pset_chunk(dcpl, 2, chunk) < 0 ||
      H5Pset_filter(dcpl, FILTER_DELTARICE, H5Z_FLAG_MANDATORY, 2,
                    cd_values) < 0)
    return fprintf(stderr, "dcpl setup failed\n"), 1;
  hid_t dset = H5Dcreate(f, "waveforms", H5T_NATIVE_SHORT, space,
                         H5P_DEFAULT, dcpl, H5P_DEFAULT);
  if (dset < 0) return fprintf(stderr, "H5Dcreate failed\n"), 1;
  if (H5Dwrite(dset, H5T_NATIVE_SHORT, H5S_ALL, H5S_ALL, H5P_DEFAULT,
               data) < 0)
    return fprintf(stderr, "H5Dwrite failed\n"), 1;
  H5Dclose(dset);
  H5Pclose(dcpl);
  H5Sclose(space);
  H5Fclose(f);

  /* --- read back & verify -------------------------------------------- */
  f = H5Fopen(path, H5F_ACC_RDONLY, H5P_DEFAULT);
  if (f < 0) return fprintf(stderr, "H5Fopen failed\n"), 1;
  dset = H5Dopen(f, "waveforms", H5P_DEFAULT);
  if (dset < 0) return fprintf(stderr, "H5Dopen failed\n"), 1;
  if (H5Dread(dset, H5T_NATIVE_SHORT, H5S_ALL, H5S_ALL, H5P_DEFAULT,
              back) < 0)
    return fprintf(stderr, "H5Dread failed\n"), 1;
  H5Dclose(dset);
  H5Fclose(f);

  if (memcmp(data, back, sizeof data) != 0) {
    for (int r = 0; r < ROWS; r++)
      for (int c = 0; c < COLS; c++)
        if (data[r][c] != back[r][c])
          return fprintf(stderr, "mismatch at [%d][%d]: %d != %d\n", r, c,
                         data[r][c], back[r][c]),
                 1;
  }
  printf("deltarice C round-trip OK (%d x %d int16, chunked %d x %d)\n",
         ROWS, COLS, CHUNK_ROWS, COLS);
  return 0;
}
