// Light-space occlusion for ray-traced shadows on Hopper (sm_90a): per
// screen tile, receivers (light-space x, y and depth) against the caster
// triangle blocks binned to the tile's receiver bbox. A receiver is
// occluded (0) iff some live caster of its tile's listed blocks whose bbox
// overlaps the tile's receiver bbox covers it: all three sign-normalized
// edge functions >= 0, w_den > 0 and z_num < ld * w_den. Otherwise it is
// lit (1).
//
// Replaces renderer_tpu/ops/rt_grid.py:_occlusion_kernel (launched by
// occlusion_grid). Caster setup and binning stay plain PyTorch
// (ops/rt_grid.py), as they were XLA code outside the Pallas body; this is
// the per-receiver walk.
//
// What bounds it on the H100: the edge and depth arithmetic of the
// (receiver, hit caster) pairs, ~25 FP32 operations each, not bytes. What
// a walk of whole listed blocks spends its time on is neither: at the
// bench grid at most ~3.4% of the listed casters overlap a tile's receiver
// bbox, yet each listed block costs a 5 KB stage and two barriers, and
// 510 tiles of uneven list length (mean 404.5, max 645 blocks) make one
// wave whose slowest tile sets the time.
//
// Design: rtt_occlusion_tiles, one call per traced slot, launches three
// kernels on the caller's stream.
// 1. occlusion_prep_kernel: a contiguous bbox side copy of every caster
//    slot (16 B: xmin, xmax, ymin, ymax; NaN for a dead caster, so the live
//    test folds into the bbox compares, which are all false for NaN), and
//    the plane set to 1 (lit).
// 2. occlusion_items_kernel (one block): each tile's bin list is cut into
//    segments of `seg` blocks; the work items (tile, segment) are listed
//    with the tiles of the most segments first (a counting sort).
// 3. occlusion_walk_kernel: a persistent grid, sized to the resident CTAs
//    (SMs x occupancy), pulls items through an atomic counter that
//    cudaMemsetAsync zeroes on the same stream. A CTA of 256 threads holds
//    one 16x64 tile, 4 receivers per thread (one column, 4 rows) in
//    registers. It tests the segment's casters 256 at a time, one per
//    thread, against the tile's receiver bbox, reading only their 16-byte
//    bbox from the side copy. The chunks are double-buffered with cp.async
//    (each thread loads the slot it tests, so the ring needs no barrier),
//    so the next chunk loads while this one is tested; the segment's block
//    ids sit in shared memory, so no dependent global load is on that
//    loop's path. The hits are compacted in shared memory (ballot + popc,
//    one shared atomic per warp); only they are staged, floats 0..15 of the
//    record (the 15 used, edges O_E, depths O_Z, O_W, and one more for
//    16-byte loads), and every thread walks them against its pending
//    receivers. A walk starts once WALK_MIN hits are staged and at the
//    segment's end.
// - Segments of one tile combine by OR: a segment stores 0 for the
//   receivers it finds occluded and nothing else, the value any other
//   segment would store, so the plane does not depend on the order of the
//   items or on `seg`.
// - Early exit: within a segment a receiver already occluded is not tested
//   again, a thread whose live receivers are all occluded stops walking,
//   and the CTA leaves the segment once every live receiver of the tile is.
// - No tensor cores: the per-pair work is three 2-term edge functions, two
//   3-term dots and six compares; no matrix product feeds wgmma. What
//   Hopper offers here is cp.async staging, occupancy (3 CTAs of 256
//   threads per SM, ~43 KB of shared memory each) and balance across the
//   132 SMs. The walk of the hit pairs takes most of the time. With no FMA
//   it issues one FP32 instruction per multiply and per add, so it can
//   reach about half of the bound, which counts 25 operations per pair at
//   the 67 TFLOP/s FMA peak.
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

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 64;
constexpr int BLOCK = 64;  // casters per record block
constexpr int REC = 20;    // floats per caster record
constexpr int THREADS = 256;
constexpr int MIN_CTAS_PER_SM = 3;  // 4 spills at the 64 registers it leaves
constexpr int PIX = TILE_H * TILE_W / THREADS;  // receivers per thread (4)
constexpr int CHUNK_BLOCKS = THREADS / BLOCK;   // blocks per tested chunk: one caster per thread
constexpr int STAGES = 2;  // chunks in the cp.async ring: STAGES - 1 in flight while one is tested
constexpr int SEG_MAX = 64;    // most blocks per segment (ops/occlusion_cuda.py SEGMENT_MAX)
constexpr int WALK_MIN = 256;  // staged hits that start a walk before the segment's end
constexpr int HIT_CAP = WALK_MIN + THREADS;  // below WALK_MIN, plus one chunk
constexpr int ITEM_THREADS = 1024;
constexpr int SORT_BUCKETS = ITEM_THREADS;  // segment counts, the last bucket open-ended

// record columns (ops/occlusion_cuda.py O_*)
constexpr int O_BB = 15;  // 15..18 light NDC bbox xmin, xmax, ymin, ymax
constexpr int O_OK = 19;  // 1.0 live, 0.0 dead

struct Scratch {
  int* counter;  // next work item (zeroed by cudaMemsetAsync)
  int* n_items;
  float4* bb;    // per caster slot: xmin, xmax, ymin, ymax; NaN if dead
  int* order;    // tiles, most segments first
  int2* items;   // (tile, segment)
};

// Lays out the scratch as ops/occlusion_cuda.py:scratch_bytes counts it;
// returns its size in bytes.
size_t carve(void* base, int n_tiles, int n_blocks, int seg, Scratch* sc) {
  char* p = static_cast<char*>(base);
  const size_t n_casters = (size_t)n_blocks * BLOCK;
  const size_t n_order = (size_t)n_tiles + (n_tiles & 1);
  const size_t n_items = (size_t)n_tiles * ((n_blocks + seg - 1) / seg);
  sc->counter = reinterpret_cast<int*>(p);
  sc->n_items = sc->counter + 1;
  sc->bb = reinterpret_cast<float4*>(p + 16);
  sc->order = reinterpret_cast<int*>(p + 16 + 16 * n_casters);
  sc->items = reinterpret_cast<int2*>(p + 16 + 16 * n_casters + 4 * n_order);
  return 16 + 16 * n_casters + 4 * n_order + 8 * n_items;
}

__device__ __forceinline__ int segments(int count, int seg) { return (count + seg - 1) / seg; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ bool any_of(const bool (&v)[N]) {
  bool a = false;
#pragma unroll
  for (int i = 0; i < N; ++i) a |= v[i];
  return a;
}

__device__ __forceinline__ float edge_fn(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float dot3(float l0, float l1, float l2, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l0, a), __fmul_rn(l1, b)), __fmul_rn(l2, c));
}

__global__ void occlusion_prep_kernel(const float* __restrict__ rec, int n_casters,
                                      float4* __restrict__ bb, float* __restrict__ occ,
                                      int n_recv) {
  const float nan = __int_as_float(0x7fc00000);
  const int n = max(n_casters, n_recv);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (i < n_casters) {
      const float* r = rec + (size_t)i * REC;
      bb[i] = r[O_OK] > 0.5f ? make_float4(r[O_BB], r[O_BB + 1], r[O_BB + 2], r[O_BB + 3])
                             : make_float4(nan, nan, nan, nan);
    }
    if (i < n_recv) occ[i] = 1.0f;
  }
}

// Inclusive sum of v over the ITEM_THREADS threads of the block, in thread
// order. Every thread of the block calls it.
__device__ int block_inclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(ITEM_THREADS)
occlusion_items_kernel(const int* __restrict__ block_count, int n_tiles, int seg,
                       int* __restrict__ order, int2* __restrict__ items,
                       int* __restrict__ n_items) {
  __shared__ int bucket_pos[SORT_BUCKETS];
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int t = threadIdx.x;
  auto bucket = [&](int tile) { return min(segments(block_count[tile], seg), SORT_BUCKETS - 1); };

  bucket_pos[t] = 0;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int i = t; i < n_tiles; i += ITEM_THREADS) atomicAdd(&bucket_pos[bucket(i)], 1);
  __syncthreads();
  // the first place of bucket b in the order: the buckets above it come first
  const int b = SORT_BUCKETS - 1 - t;
  const int size = bucket_pos[b];
  bucket_pos[b] = block_inclusive_sum(size, warp_sums) - size;
  __syncthreads();
  for (int i = t; i < n_tiles; i += ITEM_THREADS) order[atomicAdd(&bucket_pos[bucket(i)], 1)] = i;
  __syncthreads();
  // each tile's first item: a running sum of the segments in that order
  for (int base = 0; base < n_tiles; base += ITEM_THREADS) {
    const int p = base + t;
    const int tile = p < n_tiles ? order[p] : 0;
    const int s = p < n_tiles ? segments(block_count[tile], seg) : 0;
    const int end = block_inclusive_sum(s, warp_sums);
    const int first = carry + end - s;
    for (int k = 0; k < s; ++k) items[first + k] = make_int2(tile, k);
    __syncthreads();  // every thread has read carry
    if (t == ITEM_THREADS - 1) carry += end;
    __syncthreads();
  }
  if (t == 0) *n_items = carry;
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS_PER_SM)
occlusion_walk_kernel(const float* __restrict__ rec, const float4* __restrict__ bb,
                      const int* __restrict__ block_list, const int* __restrict__ block_count,
                      const float* __restrict__ tile_bbox, const float* __restrict__ lx,
                      const float* __restrict__ ly, const float* __restrict__ ld,
                      const int2* __restrict__ items, const int* __restrict__ n_items,
                      int* __restrict__ counter, int n_blocks, int n_tx, int width, int seg,
                      float* __restrict__ occ) {
  __shared__ __align__(16) float4 s_bb[STAGES][THREADS];  // chunk ring, one slot per thread
  __shared__ __align__(16) float4 s_rec[HIT_CAP][4];  // staged hits: record floats 0..15
  __shared__ int s_hit[HIT_CAP];                      // compacted hit caster slots
  __shared__ int s_blk[SEG_MAX];                      // the segment's block ids
  __shared__ int s_item, s_nhit;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int col = t % TILE_W;
  const int row0 = (t / TILE_W) * PIX;
  const int slot = t / BLOCK;  // block of a chunk whose caster t % BLOCK this thread tests
  const int total = *n_items;

  for (;;) {
    if (t == 0) {
      s_item = atomicAdd(counter, 1);
      s_nhit = 0;
    }
    __syncthreads();
    const int item = s_item;
    if (item >= total) break;
    const int2 it = items[item];
    const int tile = it.x;
    const int first = it.y * seg;
    const int nb = min(seg, block_count[tile] - first);
    if (t < nb) s_blk[t] = block_list[(size_t)tile * n_blocks + first + t];

    const int ty = tile / n_tx;
    const int tx = tile - ty * n_tx;
    float rx[PIX], ry[PIX], rd[PIX];
    bool pending[PIX];  // live (finite ld) and not yet found occluded
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
    __syncthreads();  // s_blk is complete

    const int n_chunks = (nb + CHUNK_BLOCKS - 1) / CHUNK_BLOCKS;
    auto issue = [&](int c) {  // this thread's bbox of chunk c into its ring slot
      const int j = c * CHUNK_BLOCKS + slot;
      if (c < n_chunks && j < nb) cp_async16(&s_bb[c % STAGES][t], bb + (size_t)s_blk[j] * BLOCK + t % BLOCK);
      cp_async_commit();
    };
    int n = 0;  // hits staged in s_hit (s_nhit only places them)
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) issue(c);
    for (int c = 0; c < n_chunks; ++c) {
      issue(c + STAGES - 1);
      cp_async_wait<STAGES - 1>();  // chunk c has landed; the next ones are in flight
      const int j = c * CHUNK_BLOCKS + slot;
      bool hit = false;
      if (j < nb) {
        const float4 b = s_bb[c % STAGES][t];
        hit = b.x <= bx1 && b.y >= bx0 && b.z <= by1 && b.w >= by0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_nhit, __popc(m));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (hit) s_hit[base + __popc(m & ((1u << lane) - 1u))] = s_blk[j] * BLOCK + t % BLOCK;
      }
      n += __syncthreads_count(hit);
      if (n < WALK_MIN && (c + 1 < n_chunks || n == 0)) continue;

      for (int q = t; q < 4 * n; q += THREADS) {
        s_rec[q >> 2][q & 3] =
            __ldg(reinterpret_cast<const float4*>(rec + (size_t)s_hit[q >> 2] * REC) + (q & 3));
      }
      __syncthreads();  // staged
      if (t == 0) s_nhit = 0;  // no append before the barrier that ends the walk
      for (int k = 0; k < n; ++k) {
        // e0..e3 = floats 0..15: a0 b0 c0 a1 | b1 c1 a2 b2 | c2 z0 z1 z2 | w0 w1 w2 -
        const float4 e0 = s_rec[k][0], e1 = s_rec[k][1], e2 = s_rec[k][2], e3 = s_rec[k][3];
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          if (!pending[p]) continue;
          const float lam0 = edge_fn(e0.x, e0.y, e0.z, rx[p], ry[p]);
          const float lam1 = edge_fn(e0.w, e1.x, e1.y, rx[p], ry[p]);
          const float lam2 = edge_fn(e1.z, e1.w, e2.x, rx[p], ry[p]);
          if (lam0 >= 0.0f && lam1 >= 0.0f && lam2 >= 0.0f) {
            const float z_num = dot3(lam0, lam1, lam2, e2.y, e2.z, e2.w);
            const float w_den = dot3(lam0, lam1, lam2, e3.x, e3.y, e3.z);
            if (w_den > 0.0f && z_num < __fmul_rn(rd[p], w_den)) {
              occluded[p] = true;
              pending[p] = false;
            }
          }
        }
        if (!any_of(pending)) break;
      }
      n = 0;
      // every live receiver of the tile is occluded: leave the segment
      if (__syncthreads_and(!any_of(pending))) break;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      if (occluded[p]) occ[(size_t)(ty * TILE_H + row0 + p) * width + tx * TILE_W + col] = 0.0f;
    }
    __syncthreads();  // the item's shared state is no longer read
  }
}

}  // namespace

// Launches the three kernels on `stream`; returns the first CUDA error (0 on
// success). `scratch` holds `scratch_bytes` bytes of device memory, at least
// what ops/occlusion_cuda.py:scratch_bytes counts for these sizes.
extern "C" int rtt_occlusion_tiles(const float* rec, const int* block_list,
                                   const int* block_count, const float* tile_bbox,
                                   const float* lx, const float* ly, const float* ld,
                                   int n_tiles, int n_blocks, int n_tx, int width, int seg,
                                   float* occ, void* scratch, size_t scratch_bytes,
                                   void* stream) {
  Scratch sc;
  if (seg < 1 || seg > SEG_MAX || n_tiles < 0 || n_blocks < 0 ||
      carve(scratch, n_tiles, n_blocks, seg, &sc) > scratch_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaMemsetAsync(sc.counter, 0, 2 * sizeof(int), s);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, occlusion_walk_kernel, THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;

  const int n_casters = n_blocks * BLOCK;
  const int n_recv = n_tiles * TILE_H * TILE_W;
  const int n = n_casters > n_recv ? n_casters : n_recv;
  const int prep_blocks = (n + 255) / 256 < 8 * sms ? (n + 255) / 256 : 8 * sms;
  occlusion_prep_kernel<<<prep_blocks, 256, 0, s>>>(rec, n_casters, sc.bb, occ, n_recv);
  occlusion_items_kernel<<<1, ITEM_THREADS, 0, s>>>(block_count, n_tiles, seg, sc.order,
                                                    sc.items, sc.n_items);
  const long long max_items = (long long)n_tiles * ((n_blocks + seg - 1) / seg);
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(max_items < resident ? max_items : resident);
  if (grid > 0) {
    occlusion_walk_kernel<<<grid, THREADS, 0, s>>>(rec, sc.bb, block_list, block_count,
                                                   tile_bbox, lx, ly, ld, sc.items, sc.n_items,
                                                   sc.counter, n_blocks, n_tx, width, seg, occ);
  }
  return (int)cudaGetLastError();
}
