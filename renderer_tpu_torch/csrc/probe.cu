// Two small kernels that lie on no path of the renderer, kept as the
// counterparts of the repository's two measurement kernels for the TPU:
//
// - add_one: x + 1 on an (8, 128) f32 array. Replaces the probe kernel `k`
//   of tests/test_tpu_hw.py (a check that the TPU compile service builds
//   and runs a kernel). Bound: 4 KB in and 4 KB out, a few nanoseconds of
//   HBM time: the launch costs more than the work.
// - transpose: (E, k) -> (k, E) f32 through shared memory. Replaces
//   scripts/prof_phasea.py:_tr_kernel (pallas_transpose, a layout-firewall
//   measurement). Bound: bytes, 2 * E * k * 4 B over the HBM bandwidth
//   (3.35 TB/s); it does no arithmetic.
//
// Design of the transpose: 32x32 tiles, a block of 32x8 threads, each
// thread moving 4 elements; rows of the tile are read and written by
// consecutive threads (coalesced 128-byte lines on both sides), and the
// shared tile has one column of padding so the transposed reads hit 32
// different banks. Ragged edges (k = 36 is not a multiple of 32) are
// masked.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;      // tile side
constexpr int ROWS_PER = 8;  // thread rows per block (each moves T / ROWS_PER elements)

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __fadd_rn(x[i], 1.0f);
}

// in: (rows, cols) row-major; out: (cols, rows) row-major
__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int rows, int cols) {
  __shared__ float tile[T][T + 1];
  const int c0 = blockIdx.x * T;
  const int r0 = blockIdx.y * T;
  const int tx = threadIdx.x;
  for (int j = threadIdx.y; j < T; j += ROWS_PER) {
    const int r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) tile[j][tx] = in[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < T; j += ROWS_PER) {
    const int c = c0 + j, r = r0 + tx;  // out row c, column r
    if (r < rows && c < cols) out[(size_t)c * rows + r] = tile[tx][j];
  }
}

}  // namespace

// Launches on `stream`; each returns cudaGetLastError() (0 on success).
extern "C" int rtt_add_one(const float* x, float* y, int n, void* stream) {
  if (n > 0) add_one_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

extern "C" int rtt_transpose(const float* in, float* out, int rows, int cols, void* stream) {
  if (rows > 0 && cols > 0) {
    const dim3 grid((cols + T - 1) / T, (rows + T - 1) / T);
    transpose_kernel<<<grid, dim3(T, ROWS_PER), 0, (cudaStream_t)stream>>>(in, out, rows, cols);
  }
  return (int)cudaGetLastError();
}
