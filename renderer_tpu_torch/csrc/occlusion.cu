// Light-space occlusion for ray-traced shadows on Hopper (sm_90a): per
// screen tile, receivers (light-space x, y and depth) against the caster
// triangle blocks binned to the tile's receiver bbox. A receiver is
// occluded (0) iff some live caster covers it: all three sign-normalized
// edge functions >= 0, w_den > 0 and z_num < ld * w_den. Otherwise it is
// lit (1).
//
// Replaces renderer_tpu/ops/rt_grid.py:_occlusion_kernel (launched by
// occlusion_grid). Caster setup and binning stay plain PyTorch
// (ops/rt_grid.py), as they were XLA code outside the Pallas body; this
// kernel is the per-receiver walk. The TPU kernel's double-buffered
// block-by-block DMA is not carried over: a tile stages each listed block
// in shared memory and every thread tests its receivers against it.
//
// What bounds it on the H100: the edge and depth arithmetic, not bytes.
// Per receiver it reads lx, ly, ld and writes occ (16 B); per (receiver,
// caster) pair visited it spends ~25 FP32 operations (three edge functions,
// two three-term dots, one product, six compares). The bound is the larger
// of pairs x 25 / 67 TFLOP/s (FP32 outside the tensor cores) and receivers
// x 16 B / 3.35 TB/s; at the bench the pairs dominate by orders of
// magnitude, so the kernel is bound by its instruction issue.
//
// What the design does about that:
// - One CUDA block (256 threads) per 16x64 screen tile, 4 receivers per
//   thread (one column, 4 rows), so a warp reads 32 consecutive columns;
//   the receivers stay in registers for the whole walk and each is written
//   once.
// - The tile walks its ascending bin list (uncapped, in device memory). For
//   each listed block the 64 caster records (20 floats each) are staged in
//   shared memory with 16-byte loads, and the live + bbox-overlap test of
//   each caster against the tile's receiver bbox is made once per block by
//   a ballot into a 64-bit mask, uniform across the block: the walk over
//   its set bits never diverges.
// - Early exit: a receiver already occluded is not tested again, a thread
//   whose live receivers are all occluded stops walking, and the block
//   leaves once every live receiver of the tile is occluded
//   (__syncthreads_and). The result is an OR over casters, so order and
//   early exit cannot change it.
//
// Exactness against the plain PyTorch version (bit for bit): every product
// and sum uses __fmul_rn / __fadd_rn in the plain version's order (no FMA
// contraction; built with -fmad=false), denormals are kept, and the caster
// test is the same predicate.
//
// Receivers with ld = +inf (background, padding, pixels of another cube
// face) are skipped: they stay lit and do not widen the tile bbox. The JAX
// kernel tests them like live receivers inside a walked tile (ld * w_den =
// +inf there), which makes its answer for them depend on its 32x128
// tiling; the port's answer does not depend on the tiling.
//
// Later work (not done here): an occupancy study, warp-level bbox culling
// of casters against each warp's own receiver bbox, cp.async double
// buffering of the record blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 64;
constexpr int BLOCK = 64;  // casters per record block
constexpr int REC = 20;    // floats per caster record
constexpr int THREADS = 256;
constexpr int PIX = TILE_H * TILE_W / THREADS;  // receivers per thread (4)

// record columns (ops/occlusion_cuda.py O_*)
constexpr int O_E = 0;    // 0..8 sign-normalized edge coefficients a, b, c x3
constexpr int O_Z = 9;    // 9..11 z_clip per corner
constexpr int O_W = 12;   // 12..14 w_clip per corner
constexpr int O_BB = 15;  // 15..18 light NDC bbox xmin, xmax, ymin, ymax
constexpr int O_OK = 19;  // 1.0 live, 0.0 dead

__device__ __forceinline__ float edge_fn(const float* r, int e, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[O_E + 3 * e], x), __fmul_rn(r[O_E + 3 * e + 1], y)),
                   r[O_E + 3 * e + 2]);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b[0]), __fmul_rn(a1, b[1])), __fmul_rn(a2, b[2]));
}

__global__ void __launch_bounds__(THREADS)
occlusion_tiles_kernel(const float* __restrict__ rec,
                       const int* __restrict__ block_list,
                       const int* __restrict__ block_count,
                       const float* __restrict__ tile_bbox,
                       const float* __restrict__ lx,
                       const float* __restrict__ ly,
                       const float* __restrict__ ld,
                       int n_blocks, int n_tx, int width,
                       float* __restrict__ occ) {
  __shared__ __align__(16) float srec[BLOCK * REC];
  __shared__ unsigned int shit[BLOCK / 32];

  const int tile = blockIdx.x;
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  const int t = threadIdx.x;
  const int col = t % TILE_W;
  const int row0 = (t / TILE_W) * PIX;
  float rx[PIX], ry[PIX], rd[PIX];
  bool pending[PIX];   // live (finite ld) and not yet found occluded
  bool occluded[PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const size_t o = (size_t)(ty * TILE_H + row0 + p) * width + tx * TILE_W + col;
    rx[p] = lx[o];
    ry[p] = ly[o];
    rd[p] = ld[o];
    pending[p] = isfinite(rd[p]);
    occluded[p] = false;
  }
  const float bx0 = tile_bbox[4 * tile], bx1 = tile_bbox[4 * tile + 1];
  const float by0 = tile_bbox[4 * tile + 2], by1 = tile_bbox[4 * tile + 3];

  const int count = block_count[tile];
  const int* lst = block_list + (size_t)tile * n_blocks;
  for (int i = 0; i < count; ++i) {
    const bool done = !(pending[0] || pending[1] || pending[2] || pending[3]);
    // every thread is done with the previous block; leave once every live
    // receiver of the tile is occluded
    if (__syncthreads_and(done)) break;
    const int blk = lst[i];
    const float4* src = reinterpret_cast<const float4*>(rec + (size_t)blk * BLOCK * REC);
    float4* dst = reinterpret_cast<float4*>(srec);
    for (int j = t; j < BLOCK * REC / 4; j += THREADS) dst[j] = src[j];
    if (t < BLOCK) {  // warps 0 and 1: one caster each, the block-uniform test
      const float* r = rec + ((size_t)blk * BLOCK + t) * REC;
      const bool hit = r[O_OK] > 0.5f && r[O_BB] <= bx1 && r[O_BB + 1] >= bx0 &&
                       r[O_BB + 2] <= by1 && r[O_BB + 3] >= by0;
      const unsigned int bits = __ballot_sync(0xffffffffu, hit);
      if ((t & 31) == 0) shit[t >> 5] = bits;
    }
    __syncthreads();
    if (done) continue;

    unsigned long long m = (unsigned long long)shit[0] | ((unsigned long long)shit[1] << 32);
    while (m) {
      const int k = __ffsll((long long)m) - 1;
      m &= m - 1;
      const float* r = srec + k * REC;
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        if (!pending[p]) continue;
        const float lam0 = edge_fn(r, 0, rx[p], ry[p]);
        const float lam1 = edge_fn(r, 1, rx[p], ry[p]);
        const float lam2 = edge_fn(r, 2, rx[p], ry[p]);
        if (lam0 >= 0.0f && lam1 >= 0.0f && lam2 >= 0.0f) {
          const float z_num = dot3(lam0, lam1, lam2, r + O_Z);
          const float w_den = dot3(lam0, lam1, lam2, r + O_W);
          if (w_den > 0.0f && z_num < __fmul_rn(rd[p], w_den)) {
            occluded[p] = true;
            pending[p] = false;
          }
        }
      }
      if (!(pending[0] || pending[1] || pending[2] || pending[3])) break;
    }
  }

#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const size_t o = (size_t)(ty * TILE_H + row0 + p) * width + tx * TILE_W + col;
    occ[o] = occluded[p] ? 0.0f : 1.0f;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rtt_occlusion_tiles(const float* rec, const int* block_list,
                                   const int* block_count, const float* tile_bbox,
                                   const float* lx, const float* ly, const float* ld,
                                   int n_tiles, int n_blocks, int n_tx, int width, float* occ,
                                   void* stream) {
  if (n_tiles > 0) {
    occlusion_tiles_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rec, block_list, block_count, tile_bbox, lx, ly, ld, n_blocks, n_tx, width, occ);
  }
  return (int)cudaGetLastError();
}
