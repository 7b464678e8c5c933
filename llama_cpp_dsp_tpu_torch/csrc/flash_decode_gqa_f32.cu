// B2 (flash_decode_gqa.cuh) over f32 rows: the kernels of one row type in a
// translation unit of their own, so the three build side by side.
#include "flash_decode_gqa.cuh"

template int gqa::launch_row<gqa::F32>(const gqa::Args&, int, int, int, cudaStream_t);
