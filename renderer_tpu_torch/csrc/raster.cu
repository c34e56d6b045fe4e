// Tile rasterizer for Hopper (sm_90a): depth test + triangle id (+ optional
// normalized barycentrics) over binned 64-triangle record blocks.
//
// Replaces renderer_tpu/ops/raster_pallas.py:_raster_kernel (launched by
// rasterize_pallas). Semantics: renderer_tpu/ops/raster_spec.py. Triangle
// setup and binning stay plain PyTorch (ops/raster_cuda.py), as they were
// XLA code outside the Pallas body; this is the per-pixel loop.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 6): neither bytes nor the total arithmetic, but the latency of the
// heaviest pixels' serial walk. Work is very uneven: at the bench soup a
// 16x64 tile's mask holds 30 triangles at the median and 1140 at most, on
// neighbouring tiles near the horizon. When one CTA of 8 warps stepped
// through every mask bit of its tile (each step a dependent chain of
// shared-memory loads and FP32 operations, with a block-wide barrier and
// an 8 KB stage per listed block), the heaviest tile alone took 0.452 ms
// of the kernel's 0.465 ms while most of the card idled. The whole soup
// needs 13.5 M (pixel, triangle) pairs inside the padded bboxes, ~5 us of
// FP32 issue, and ~42 MB of traffic (the four output planes and columns
// 0..21 of the listed triangles' records), ~13 us.
//
// Design: rtt_raster_tiles launches two kernels on the caller's stream.
// 1. raster_prep_kernel: a contiguous 16-byte bbox side copy (xmin, xmax,
//    ymin, ymax) of every triangle record, so that a warp reads the 64
//    bboxes of a block as two coalesced 512-byte loads. Without it, the
//    walk reading each listed triangle's bbox from its record (two 16-byte
//    loads from another 128-byte line per lane) made the call ~9 us
//    slower at the bench soup than the copy costs (chip_ab.py).
// 2. raster_walk_kernel: each warp owns one RW x RH pixel region of a tile
//    (PIX pixels per lane) and walks only the triangles that can touch it.
//    For each listed block of its tile the warp tests the block's mask
//    bits against the box of its pixel centres, lane j taking triangles j
//    and j + 32; two ballots make the warp's 64-bit hit mask. The lanes
//    holding hits copy those records into the warp's own shared memory with
//    cp.async (through L1, where the CTA's other warps find the records
//    they share), the next block's bboxes load meanwhile, and the warp
//    walks its hits in ascending order. Warps never wait for each other:
//    no barrier wider than a warp. A CTA holds WARPS regions of one tile.
// - The skip is exact: the per-pixel bbox predicate is part of coverage,
//   and it is separable and monotone per axis, so a triangle whose bbox
//   misses the region's extreme pixel centres covers none of its pixels.
//   Pixels never move between warps, so each still sees its triangles in
//   ascending id. A pixel's list is never split, so no merge is needed
//   (the rounded cross-multiplied depth compare is not transitive).
// - Per-region walks cut the longest serial chain from 1140 mask bits to
//   the most triangles reaching one 8x8 region, 216, at 2 pixels per lane.
//   Region shape, CTA size and staging were chosen by timing variants at
//   the bench soup: 8x4 regions shorten the heaviest tile's walk further
//   but pay the per-block stage wait twice as often and lose on the whole
//   soup; reading each hit's record from global memory in the walk leaves
//   its latency in the chain; 8-warp CTAs hold their slot for their
//   slowest region; launching the heaviest tiles first gained little.
// - Output planes are written with streaming stores, so that they do not
//   push the records out of L2.
// - No tensor cores: the per-pair work is three 2-term edge functions, two
//   3-term dots and compares, and an MMA would not round as the plain
//   version does.
//
// Exactness against the plain PyTorch version (bit for bit): every product
// and sum uses __fmul_rn / __fadd_rn in the plain version's order (no FMA
// contraction; built with -fmad=false), the fill rule is the full top-left
// rule (lam > 0 | lam == 0 & top_left) with denormals kept, pixels see
// triangles in ascending id with a strict depth compare (lower id wins a
// tie), depth is kept as the rational z_num / w_den (the divide-free
// compare z_num * w_den_old < z_old * w_i) with one IEEE divide per pixel
// at the end. Dead and culled triangles have zero mask bits and a poisoned
// (+inf/-inf) bbox.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 64;
constexpr int BLOCK = 64;  // triangles per record block / mask word
constexpr int ROWS = 32;   // floats per triangle record
constexpr int WARPS = 4;   // regions per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int RW = 8, RH = 8;      // one warp's pixel region
constexpr int PIX = RW * RH / 32;  // pixels per lane, stacked in a column
constexpr int NRX = TILE_W / RW;   // regions across a tile
constexpr int PARTS = TILE_W / RW * (TILE_H / RH) / WARPS;  // CTAs per tile
static_assert(PIX * 32 == RW * RH && PARTS * WARPS * RW * RH == TILE_W * TILE_H,
              "a region is a whole number of pixels per lane, a tile whole CTAs");
constexpr unsigned FULL = 0xffffffffu;

// A warp's staged records of the hits of the block it walks, slot k for
// triangle k of the block: the record columns (ops/raster_cuda.py R_*)
// 0..21 as five float4 and a float2, q[0] = a0 b0 c0 a1 | q[1] = b1 c1 a2 b2
// | q[2] = c2 z0 z1 z2 | q[3] = w0 w1 w2 xmin | q[4] = xmax ymin ymax tl0 |
// t = tl1 tl2.
struct Stage {
  float4 q[5][BLOCK];
  float2 t[BLOCK];
};

// cp.async.ca: the copy also lands in L1, where the tile's other warps
// find the records they share.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void stage_record(Stage& st, int k, const float* r) {
#pragma unroll
  for (int g = 0; g < 5; ++g) cp_async_ca<16>(&st.q[g][k], r + 4 * g);
  cp_async_ca<8>(&st.t[k], r + 20);
}

__device__ __forceinline__ float edge_fn(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool accept(float lam, float top_left) {
  return lam > 0.0f || (lam == 0.0f && top_left != 0.0f);
}

__device__ __forceinline__ float dot3(float l0, float l1, float l2, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l0, a), __fmul_rn(l1, b)), __fmul_rn(l2, c));
}

// Does bbox b (xmin, xmax, ymin, ymax) reach the box of pixel centres
// [x0, x1] x [y0, y1]? False for a poisoned bbox.
__device__ __forceinline__ bool reaches(float4 b, float x0, float x1, float y0, float y1) {
  return b.x <= x1 && b.y >= x0 && b.z <= y1 && b.w >= y0;
}

// The lane's pixels (one column, rows py) against triangle `tri`, staged
// in slot k: the plain version's coverage and depth test, in its order of
// operations.
template <bool BARY>
__device__ __forceinline__ void depth_test(const Stage& st, int k, int tri, bool simple, float px,
                                           const float (&py)[PIX], float (&zn)[PIX],
                                           float (&wd)[PIX], int (&id)[PIX], float (&l0)[PIX],
                                           float (&l1)[PIX], float (&ls)[PIX]) {
  const float4 q0 = st.q[0][k], q1 = st.q[1][k], q2 = st.q[2][k], q3 = st.q[3][k];
  const float4 q4 = st.q[4][k];
  const float2 t = st.t[k];
  if (!(px >= q3.w && px <= q4.x)) return;
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const float lam0 = edge_fn(q0.x, q0.y, q0.z, px, py[p]);
    const float lam1 = edge_fn(q0.w, q1.x, q1.y, px, py[p]);
    const float lam2 = edge_fn(q1.z, q1.w, q2.x, px, py[p]);
    if (!(accept(lam0, q4.w) && accept(lam1, t.x) && accept(lam2, t.y) && py[p] >= q4.y &&
          py[p] <= q4.z)) {
      continue;
    }
    const float w_i = dot3(lam0, lam1, lam2, q3.x, q3.y, q3.z);
    const float z_num = dot3(lam0, lam1, lam2, q2.y, q2.z, q2.w);
    if (!simple && !(w_i > 0.0f && z_num >= 0.0f && z_num <= w_i)) continue;
    if (__fmul_rn(z_num, wd[p]) < __fmul_rn(zn[p], w_i)) {
      zn[p] = z_num;
      wd[p] = w_i;
      id[p] = tri;
      if (BARY) {
        l0[p] = lam0;
        l1[p] = lam1;
        ls[p] = __fadd_rn(__fadd_rn(lam0, lam1), lam2);
      }
    }
  }
}

// bb[i] = (xmin, xmax, ymin, ymax) of record i: floats 15..18, read as the
// aligned float4s 12..15 and 16..19.
__global__ void raster_prep_kernel(const float* __restrict__ rec, int n, float4* __restrict__ bb) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float4* r4 = reinterpret_cast<const float4*>(rec + (size_t)i * ROWS);
    const float4 a = __ldg(r4 + 3), b = __ldg(r4 + 4);
    bb[i] = make_float4(a.w, b.x, b.y, b.z);
  }
}

template <bool BARY>
__global__ void __launch_bounds__(THREADS)
raster_walk_kernel(const float* __restrict__ rec, const float4* __restrict__ bb,
                   const unsigned long long* __restrict__ masks,
                   const int* __restrict__ block_list, const int* __restrict__ block_count,
                   const int* __restrict__ block_simple, int n_blocks, int n_tx, int y0,
                   int width, float* __restrict__ depth, int* __restrict__ tri_id,
                   float* __restrict__ b0_out, float* __restrict__ b1_out) {
  __shared__ __align__(16) Stage stage[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Stage& st = stage[warp];  // this warp's alone: no barrier wider than a warp
  const int tile = blockIdx.x / PARTS;
  const int region = (blockIdx.x - tile * PARTS) * WARPS + warp;
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  const int x0 = tx * TILE_W + (region % NRX) * RW;  // the region's first column
  const int r0 = ty * TILE_H + (region / NRX) * RH;  // its first row of the band
  const int col = x0 + lane % RW;
  const int row0 = r0 + (lane / RW) * PIX;
  const float px = (float)col + 0.5f;
  // the region's pixel centres span [bx0, bx1] x [by0, by1]
  const float bx0 = (float)x0 + 0.5f, bx1 = (float)(x0 + RW - 1) + 0.5f;
  const float by0 = (float)(r0 + y0) + 0.5f, by1 = (float)(r0 + y0 + RH - 1) + 0.5f;
  float py[PIX], zn[PIX], wd[PIX], l0[PIX], l1[PIX], ls[PIX];
  int id[PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    py[p] = (float)(row0 + p + y0) + 0.5f;
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
  for (int c = 0; c < count; c += 32) {
    // lane j holds list entry c + j: its block, mask word and simple flag
    const int nb = min(32, count - c);
    int my_blk = 0, my_simple = 1;
    unsigned long long my_mask = 0ull;
    if (lane < nb) {
      my_blk = lst[c + lane];
      my_mask = tmask[my_blk];
      my_simple = block_simple[my_blk];
    }
    int blk = __shfl_sync(FULL, my_blk, 0);
    float4 bb_lo = bb[(size_t)blk * BLOCK + lane], bb_hi = bb[(size_t)blk * BLOCK + 32 + lane];
    for (int b = 0; b < nb; ++b) {
      const unsigned long long m = __shfl_sync(FULL, my_mask, b);
      const bool simple = __shfl_sync(FULL, my_simple, b) != 0;
      const bool hit_lo = ((m >> lane) & 1ull) && reaches(bb_lo, bx0, bx1, by0, by1);
      const bool hit_hi = ((m >> (lane + 32)) & 1ull) && reaches(bb_hi, bx0, bx1, by0, by1);
      unsigned long long hits = ((unsigned long long)__ballot_sync(FULL, hit_hi) << 32) |
                                __ballot_sync(FULL, hit_lo);
      const int tri0 = blk * BLOCK;
      const float* rb = rec + (size_t)tri0 * ROWS;
      if (hit_lo) stage_record(st, lane, rb + lane * ROWS);
      if (hit_hi) stage_record(st, lane + 32, rb + (lane + 32) * ROWS);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (b + 1 < nb) {  // the next block's bboxes load while these records land
        blk = __shfl_sync(FULL, my_blk, b + 1);
        bb_lo = bb[(size_t)blk * BLOCK + lane];
        bb_hi = bb[(size_t)blk * BLOCK + 32 + lane];
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      while (hits) {
        const int k = __ffsll((long long)hits) - 1;  // ascending triangle order
        hits &= hits - 1;
        depth_test<BARY>(st, k, tri0 + k, simple, px, py, zn, wd, id, l0, l1, ls);
      }
      __syncwarp();  // the stage is read before the next block's hits land in it
    }
  }

  // streaming stores: the planes are not read again here, so they should
  // not push the records out of L2
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const size_t o = (size_t)(row0 + p) * width + col;
    __stcs(depth + o, __fdiv_rn(zn[p], wd[p]));
    __stcs(tri_id + o, id[p]);
    if (BARY) {
      const float inv = __fdiv_rn(1.0f, ls[p] != 0.0f ? ls[p] : 1.0f);
      __stcs(b0_out + o, __fmul_rn(l0[p], inv));
      __stcs(b1_out + o, __fmul_rn(l1[p], inv));
    } else {
      __stcs(b0_out + o, 0.0f);
      __stcs(b1_out + o, 0.0f);
    }
  }
}

}  // namespace

// Launches the two kernels on `stream`; returns cudaGetLastError() (0 on
// success). `bb_scratch` holds 16 bytes of device memory per triangle
// record (n_blocks * 64), 16-byte aligned, as does `rec`.
extern "C" int rtt_raster_tiles(const float* rec, const unsigned long long* masks,
                                const int* block_list, const int* block_count,
                                const int* block_simple, int n_tiles, int n_blocks,
                                int n_tx, int y0, int width, int with_bary, float* depth,
                                int* tri_id, float* b0, float* b1, void* bb_scratch,
                                void* stream) {
  if (n_tiles < 0 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  float4* bb = static_cast<float4*>(bb_scratch);
  const int n = n_blocks * BLOCK;
  if (n > 0) raster_prep_kernel<<<(n + 255) / 256, 256, 0, s>>>(rec, n, bb);
  if (with_bary) {
    raster_walk_kernel<true><<<n_tiles * PARTS, THREADS, 0, s>>>(
        rec, bb, masks, block_list, block_count, block_simple, n_blocks, n_tx, y0, width,
        depth, tri_id, b0, b1);
  } else {
    raster_walk_kernel<false><<<n_tiles * PARTS, THREADS, 0, s>>>(
        rec, bb, masks, block_list, block_count, block_simple, n_blocks, n_tx, y0, width,
        depth, tri_id, b0, b1);
  }
  return (int)cudaGetLastError();
}
