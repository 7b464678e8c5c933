// B7 (flash_decode_gqa.cuh) over paged int8 rows with f32 row scales: the
// kernels of one row type and source in a translation unit of their own, so
// they build beside B2's.
#include "flash_decode_gqa.cuh"

template int gqa::launch_row<gqa::I8, true>(const gqa::Args&, int, int, int, cudaStream_t);
