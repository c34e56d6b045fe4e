// Tile rasterizer for Hopper (sm_90a): depth test + triangle id (+ optional
// normalized barycentrics) over binned 64-triangle record blocks.
//
// Replaces renderer_tpu/ops/raster_pallas.py:_raster_kernel (launched by
// rasterize_pallas). Semantics: renderer_tpu/ops/raster_spec.py. Triangle
// setup and binning stay plain PyTorch (ops/raster_cuda.py), as they were
// XLA code outside the Pallas body; this kernel is the per-pixel loop.
//
// What bounds it on the H100: issue rate of the per-pixel edge/depth
// arithmetic and its branches, not bytes. Per visited block it reads one
// 8 KB record block and one 8-byte mask word; per triangle hit it spends
// ~25 FP32 operations per pixel. The work scales with (tile, triangle)
// pairs times pixels per tile.
//
// What the design does about that:
// - One CUDA block (256 threads) per 16x64 pixel tile; each thread owns a
//   column of 4 pixels and keeps z_num, w_den and the id (and lam0, lam1,
//   sum) in registers for the whole walk, so nothing round-trips through
//   device memory until the epilogue writes each pixel once.
// - The tile walks its ascending bin list (uncapped, in device memory). The
//   block's 64 records are staged in shared memory with 16-byte loads; the
//   64-bit per-tile triangle mask is uniform across the block, so the walk
//   over its set bits (__ffsll, ascending) never diverges.
// - A thread skips a triangle whose padded screen bbox misses all four of
//   its pixels; a warp (32 columns x 4 rows) skips as a unit. The same
//   per-pixel bbox predicate is part of coverage in the plain version.
// - Depth is kept as the rational z_num / w_den (the divide-free compare
//   z_num * w_den_old < z_old * w_i); one IEEE divide per pixel at the end.
//
// Exactness against the plain PyTorch version (bit for bit): every product
// and sum uses __fmul_rn / __fadd_rn in the plain version's order (no FMA
// contraction), the fill rule is the full top-left rule
// (lam > 0 | lam == 0 & top_left) with denormals kept, pixels see
// triangles in ascending id with a strict depth compare (lower id wins a
// tie), and divides are IEEE. Dead and culled triangles have zero mask
// bits and a poisoned (+inf/-inf) bbox.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 64;
constexpr int BLOCK = 64;  // triangles per record block / mask word
constexpr int ROWS = 32;   // floats per triangle record
constexpr int THREADS = 256;
constexpr int PIX = TILE_H * TILE_W / THREADS;  // pixels per thread (4)

// record columns (ops/raster_cuda.py R_*)
constexpr int R_E = 0;    // 0..8 oriented edge coefficients a, b, c x3
constexpr int R_Z = 9;    // 9..11 z_clip per corner
constexpr int R_W = 12;   // 12..14 w_clip per corner
constexpr int R_BB = 15;  // 15..18 xmin, xmax, ymin, ymax (pixel coords)
constexpr int R_TL = 19;  // 19..21 top-left flag per edge (1.0 / 0.0)

__device__ __forceinline__ float edge_fn(const float* r, int e, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[R_E + 3 * e], px), __fmul_rn(r[R_E + 3 * e + 1], py)),
                   r[R_E + 3 * e + 2]);
}

__device__ __forceinline__ bool accept(float lam, float top_left) {
  return lam > 0.0f || (lam == 0.0f && top_left != 0.0f);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b[0]), __fmul_rn(a1, b[1])), __fmul_rn(a2, b[2]));
}

__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float* __restrict__ rec,
                    const unsigned long long* __restrict__ masks,
                    const int* __restrict__ block_list,
                    const int* __restrict__ block_count,
                    const int* __restrict__ block_simple,
                    int n_blocks, int n_tx, int y0, int width, int with_bary,
                    float* __restrict__ depth, int* __restrict__ tri_id,
                    float* __restrict__ b0_out, float* __restrict__ b1_out) {
  __shared__ __align__(16) float srec[BLOCK * ROWS];

  const int tile = blockIdx.x;
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  const int t = threadIdx.x;
  const int col = t % TILE_W;
  const int row0 = (t / TILE_W) * PIX;
  const float px = (float)(tx * TILE_W + col) + 0.5f;
  float py[PIX];
  float zn[PIX], wd[PIX], l0[PIX], l1[PIX], ls[PIX];
  int id[PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    py[p] = (float)(ty * TILE_H + row0 + p + y0) + 0.5f;
    zn[p] = 1.0f;  // DEPTH_CLEAR over w_den 1
    wd[p] = 1.0f;
    id[p] = -1;
    l0[p] = 0.0f;
    l1[p] = 0.0f;
    ls[p] = 1.0f;
  }

  const int count = block_count[tile];
  const int* lst = block_list + (size_t)tile * n_blocks;
  const unsigned long long* tmask = masks + (size_t)tile * n_blocks;
  for (int i = 0; i < count; ++i) {
    const int blk = lst[i];
    unsigned long long m = tmask[blk];
    const bool simple = block_simple[blk] != 0;
    __syncthreads();  // every thread is done with the previous block
    const float4* src = reinterpret_cast<const float4*>(rec + (size_t)blk * BLOCK * ROWS);
    float4* dst = reinterpret_cast<float4*>(srec);
    for (int j = t; j < BLOCK * ROWS / 4; j += THREADS) dst[j] = src[j];
    __syncthreads();

    while (m) {
      const int k = __ffsll((long long)m) - 1;  // ascending triangle order
      m &= m - 1;
      const float* r = srec + k * ROWS;
      const float xmin = r[R_BB], xmax = r[R_BB + 1];
      const float ymin = r[R_BB + 2], ymax = r[R_BB + 3];
      if (!(px >= xmin && px <= xmax && py[PIX - 1] >= ymin && py[0] <= ymax)) continue;
      const int tri = blk * BLOCK + k;
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const float lam0 = edge_fn(r, 0, px, py[p]);
        const float lam1 = edge_fn(r, 1, px, py[p]);
        const float lam2 = edge_fn(r, 2, px, py[p]);
        const float w_i = dot3(lam0, lam1, lam2, r + R_W);
        const float z_num = dot3(lam0, lam1, lam2, r + R_Z);
        bool cov = accept(lam0, r[R_TL]) && accept(lam1, r[R_TL + 1]) &&
                   accept(lam2, r[R_TL + 2]) && py[p] >= ymin && py[p] <= ymax;
        if (!simple) cov = cov && w_i > 0.0f && z_num >= 0.0f && z_num <= w_i;
        if (cov && __fmul_rn(z_num, wd[p]) < __fmul_rn(zn[p], w_i)) {
          zn[p] = z_num;
          wd[p] = w_i;
          id[p] = tri;
          if (with_bary) {
            l0[p] = lam0;
            l1[p] = lam1;
            ls[p] = __fadd_rn(__fadd_rn(lam0, lam1), lam2);
          }
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const size_t o = (size_t)(ty * TILE_H + row0 + p) * width + tx * TILE_W + col;
    depth[o] = __fdiv_rn(zn[p], wd[p]);
    tri_id[o] = id[p];
    if (with_bary) {
      const float inv = __fdiv_rn(1.0f, ls[p] != 0.0f ? ls[p] : 1.0f);
      b0_out[o] = __fmul_rn(l0[p], inv);
      b1_out[o] = __fmul_rn(l1[p], inv);
    } else {
      b0_out[o] = 0.0f;
      b1_out[o] = 0.0f;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rtt_raster_tiles(const float* rec, const unsigned long long* masks,
                                const int* block_list, const int* block_count,
                                const int* block_simple, int n_tiles, int n_blocks,
                                int n_tx, int y0, int width, int with_bary, float* depth,
                                int* tri_id, float* b0, float* b1, void* stream) {
  if (n_tiles > 0) {
    raster_tiles_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rec, masks, block_list, block_count, block_simple, n_blocks, n_tx, y0, width,
        with_bary, depth, tri_id, b0, b1);
  }
  return (int)cudaGetLastError();
}
