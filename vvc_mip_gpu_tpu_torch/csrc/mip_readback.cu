// A pitched device-to-host copy on a caller's stream, for the readback ring
// (utils/readback.py `PartedRead.copy_columns`): one block of columns of
// every row of a device tensor into the same columns of a pinned host buffer.
//
// torch's `copy_` into a column view of a pinned tensor is not asynchronous:
// it gathers the columns into a contiguous device temporary, copies that to
// a contiguous host temporary, and scatters it on the host.  One
// cudaMemcpy2DAsync moves the block itself, row by row on the copy engine,
// at the link's rate for rows of tens of kilobytes (a 1080p frame's SizeId
// blocks are 135 rows of 55-205 KB).
//
// No kernel: the library holds this one entry point, called through ctypes
// like the kernels' wrappers.

#include <cuda_runtime.h>

#include <cstddef>

// `rows` rows of `width` bytes: row i from `src + i * src_pitch` (device
// memory) to `dst + i * dst_pitch` (page-locked host memory), enqueued on
// `stream`.  Returns the CUDA error code (0 on success).
extern "C" int mip_copy_columns_to_host(void* dst, size_t dst_pitch,
                                        const void* src, size_t src_pitch,
                                        size_t width, size_t rows,
                                        void* stream) {
  if (width == 0 || rows == 0) return (int)cudaSuccess;
  return (int)cudaMemcpy2DAsync(dst, dst_pitch, src, src_pitch, width, rows,
                                cudaMemcpyDeviceToHost,
                                static_cast<cudaStream_t>(stream));
}
