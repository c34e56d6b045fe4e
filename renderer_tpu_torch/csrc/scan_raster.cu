// Scan rasterizer for Hopper (sm_90a): every live triangle of the soup's
// first ceil(count / tri_block) blocks tested against every pixel its
// screen bbox holds, keeping per pixel the nearest (depth, id) and its
// barycentrics, bounded by the soup's count read on the device.
//
// Not a TPU kernel: the port's counterpart of the block loop that the JAX
// package runs in XLA, renderer_tpu/ops/raster_jax.py:rasterize(count=)
// (its fori_loop over ceil(count / tri_block) blocks, :82-85 and :184).
// The plain PyTorch version is ops/raster_scan.py:scan_raster_plain, and
// the per-triangle setup (edge coefficients, screen bbox, top-left flags,
// the live mask, corner z and w) stays plain PyTorch (scan_inputs), as it
// is XLA code outside the loop in the JAX package.
//
// What bounds it on the H100: the bytes of the five output planes and the
// walked triangles' setup, or the FP32 arithmetic of the (pixel, triangle)
// pairs inside the triangles' bboxes, ~25 operations each (three 2-term
// edge functions, two 3-term dots, a divide and compares), whichever is
// larger. Its cost must follow the soup's count: the walk stops at the
// count's last block, which only the device knows (the host reads nothing
// back).
//
// Design: one C call, three kernels; the second and third are launched as
// programmatic dependents of the one before, so each starts while its
// predecessor runs and waits for its end only where it reads its output.
// - scan_zero_kernel zeroes the cells' counters.
// - scan_bin_kernel, a thread per walked triangle: packs the triangle's
//   setup into one 80-byte record of five float4 (edges, z, w, top-left
//   bits, bbox; a dead triangle, not live or past the count's last block,
//   gets an empty bbox), the union of each warp's 32 bboxes (a group box),
//   and appends the triangle's index to the list of every CW x CH cell its
//   bbox reaches (one atomic per cell among a warp's lanes; a lane appends
//   a triangle of a few cells, the warp those of many at once; past
//   FINE_MOST cells, the COARSE x COARSE cells instead). The lists have a
//   fixed capacity from the host's sizes (LIST_BUDGET entries in all); a
//   cell whose counter passes it is walked from the group boxes instead.
//   This is the only pass over the whole soup: the soup's order is the
//   instances', whose screen positions do not follow it, so every region
//   reads only the triangles that reach its cell.
// - scan_walk_kernel, a CTA per 32 x 8 pixel region inside a cell, a warp
//   per 8 x 4 pixels, a pixel per lane (16 x 4 regions, four warps an area
//   each on every fourth of its triangles, when the 32 x 8 grid would hold
//   fewer than SPLIT_BELOW CTAs per SM: a small image's work piles into
//   few regions). It loads its cells' lists (fine, then coarse) into
//   shared memory, LIST entries at a time, then gathers the listed
//   records STAGE at a time into shared memory with cp.async,
//   double-buffered (the next stage in flight while this one is walked).
//   Each warp ballots which staged bboxes reach its own 8 x 4 pixels and
//   walks only those, reading each record with float4 broadcasts.
// - The winner is the order-free minimum of (z, id) over the covered
//   pixels with z < DEPTH_CLEAR (a strict < on z, then the lower id on a
//   tie), so the lists may come in any order (the appends race). The plain
//   version takes a per-block argmin (the lowest id on ties) and then a
//   strict < across blocks in id order: the same pixel. Its barycentrics
//   are the winner's own edge functions, so they are the same bits too.
// - Count semantics as in JAX: whole blocks below ceil(count / tri_block)
//   are walked, so a live triangle past the count inside the last walked
//   block is still rasterized, and every later block is skipped. No count
//   (a null pointer) walks every block.
//
// Exactness against the plain version (bit for bit): every product and
// sum uses __fmul_rn / __fadd_rn in its order, z = z_num / w_i and the
// barycentrics lam_k / lam_sum are IEEE divides (__fdiv_rn); no FMA
// contraction (built with -fmad=false); denormals kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LX = 8, LY = 4;  // an area's pixels, one per lane
constexpr int THREADS = 256;
// a CTA's region: AX x AY areas, K warps per area, each on every K-th of
// the area's triangles; the wide shape, and the split one (more, smaller
// regions, four warps an area) for a grid of the wide shape that would
// hold under SPLIT_BELOW CTAs per SM
constexpr int WIDE_AX = 4, WIDE_AY = 2, WIDE_K = 1;   // 32 x 8
constexpr int SPLIT_AX = 2, SPLIT_AY = 1, SPLIT_K = 4;  // 16 x 4
constexpr int SPLIT_BELOW = 2;
constexpr int CW = 32, CH = 32;  // a fine cell of the lists
constexpr int FINE_MOST = 32;    // fine cells of a triangle listed there; more: coarse cells
constexpr int COARSE = 256;      // a coarse cell's width and height
constexpr int GROUP = 32;        // triangles per group box: one warp of the binning
constexpr int STAGE = 128;       // triangles staged at once
constexpr int LIST = 2048;       // list entries in shared memory at once
constexpr int BOX_BATCH = LIST / GROUP;  // group boxes tested at once by a cell walked from them
constexpr int REC = 5;           // float4 per triangle record
constexpr int LANE_CELLS = 4;    // a lane lists a triangle of at most this many cells alone
constexpr long long LIST_BUDGET = 1LL << 23;  // list entries over all fine cells
constexpr long long COARSE_BUDGET = 1LL << 20;  // and over all coarse cells
constexpr int BIN_THREADS = 256;
constexpr float DEPTH_CLEAR = 1.0f;  // ops/raster_spec.py
constexpr int NO_TRIANGLE = -1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(LX * LY == 32, "an area's lanes");
static_assert(32 * WIDE_AX * WIDE_AY * WIDE_K == THREADS &&
              32 * SPLIT_AX * SPLIT_AY * SPLIT_K == THREADS, "the shapes' warps");
static_assert(CW % (LX * WIDE_AX) == 0 && CH % (LY * WIDE_AY) == 0 &&
              CW % (LX * SPLIT_AX) == 0 && CH % (LY * SPLIT_AY) == 0 &&
              COARSE % CW == 0 && COARSE % CH == 0,
              "a region lies in one fine cell, a fine cell in one coarse cell");
static_assert(FINE_MOST <= 32, "a warp lists a triangle's fine cells at once");
static_assert(STAGE % 32 == 0 && THREADS >= BOX_BATCH, "stages of ballot words, one box a thread");

// a call's scratch: records, group boxes, the counters of the fine cells
// and of the coarse cells, their lists
struct Sizes {
  int groups, cells_x, cells, cap, coarse_x, coarse, coarse_cap;
  long long bytes;
};

inline int capacity(long long budget, int cells, int most) {
  const long long fair = cells > 0 ? budget / cells : 0;
  return (int)(fair < 256 ? 256 : fair < most ? fair : most);
}

inline Sizes sizes(int n_tri, int width, int height) {
  Sizes s;
  s.groups = (n_tri + GROUP - 1) / GROUP;
  s.cells_x = (width + CW - 1) / CW;
  s.cells = s.cells_x * ((height + CH - 1) / CH);
  s.cap = capacity(LIST_BUDGET, s.cells, s.groups * GROUP);
  s.coarse_x = (width + COARSE - 1) / COARSE;
  s.coarse = s.coarse_x * ((height + COARSE - 1) / COARSE);
  s.coarse_cap = capacity(COARSE_BUDGET, s.coarse, s.groups * GROUP);
  const int counters = (s.cells + s.coarse + 3) / 4 * 4;
  s.bytes = 16LL * REC * GROUP * s.groups + 16LL * s.groups + 4LL * counters +
            4LL * s.cells * s.cap + 4LL * s.coarse * s.coarse_cap;
  return s;
}

__device__ __forceinline__ int walked(const int* count, int n_tri, int tri_block) {
  const int n_blocks = n_tri / tri_block;
  if (count == nullptr) return n_blocks * tri_block;
  const long long c = max(0, *count);
  return (int)min((c + tri_block - 1) / tri_block, (long long)n_blocks) * tri_block;
}

__device__ __forceinline__ bool overlaps(float4 b, float x0, float x1, float y0, float y1) {
  return b.x <= x1 && b.y >= x0 && b.z <= y1 && b.w >= y0;
}

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

// Programmatic dependent launch: a kernel launched with the serialization
// attribute may start once its predecessor has run launch_dependents, and
// waits with wait_prerequisites until the predecessor has completed and its
// writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ bool accept(float lam, unsigned tl, int e) {
  return lam > 0.0f || (lam == 0.0f && ((tl >> e) & 1u));
}

__device__ __forceinline__ float dot3(float l0, float l1, float l2, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l0, a), __fmul_rn(l1, b)), __fmul_rn(l2, c));
}

// A triangle's record (five float4): r0 = edge 0 (a, b, c) and edge 1's a;
// r1 = edge 1's b, c and edge 2's a, b; r2 = edge 2's c, z0, z1, z2; r3 =
// w0, w1, w2 and the top-left bits; r4 = bbox (xmin, xmax, ymin, ymax).
// Whether it covers the pixel centre (px, py) as the plain version tests
// it (bbox, the three edges with the top-left rule, w > 0) with z in
// [0, 1), and then its edge functions and z.
__device__ __forceinline__ bool covers(const float4* r, float px, float py, float& lam0,
                                       float& lam1, float& lam2, float& z) {
  const float4 box = r[4];
  if (!(px >= box.x && px <= box.y && py >= box.z && py <= box.w)) return false;
  const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3];
  const unsigned tl = __float_as_uint(r3.w);
  lam0 = __fadd_rn(__fadd_rn(__fmul_rn(r0.x, px), __fmul_rn(r0.y, py)), r0.z);
  lam1 = __fadd_rn(__fadd_rn(__fmul_rn(r0.w, px), __fmul_rn(r1.x, py)), r1.y);
  lam2 = __fadd_rn(__fadd_rn(__fmul_rn(r1.z, px), __fmul_rn(r1.w, py)), r2.x);
  if (!(accept(lam0, tl, 0) && accept(lam1, tl, 1) && accept(lam2, tl, 2))) return false;
  const float w_i = dot3(lam0, lam1, lam2, r3.x, r3.y, r3.z);
  if (!(w_i > 0.0f)) return false;
  z = __fdiv_rn(dot3(lam0, lam1, lam2, r2.y, r2.z, r2.w), w_i);
  return z >= 0.0f && z < DEPTH_CLEAR;
}

// The cells [c0, c1] of size `cell` that hold a superset of the pixel
// centres in [lo, hi] on an axis of n_pix pixels; false for none. A NaN
// bound (which covers nothing) is taken as the screen's edge.
__device__ __forceinline__ bool cell_span(float lo, float hi, int n_pix, int cell, int& c0,
                                          int& c1) {
  const float f0 = fmaxf(lo - 0.5f, 0.0f), f1 = fminf(hi - 0.5f, (float)(n_pix - 1));
  if (!(f0 <= (float)(n_pix - 1) && f1 >= 0.0f)) return false;
  c0 = (int)floorf(f0) / cell;
  c1 = (int)ceilf(f1) / cell;
  return c0 <= c1;
}

__global__ void scan_zero_kernel(int* __restrict__ counts, int n) {
  launch_dependents();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    counts[i] = 0;
  }
}

__global__ void __launch_bounds__(BIN_THREADS)
scan_bin_kernel(const float* __restrict__ adj, const float* __restrict__ bb,
                const unsigned char* __restrict__ top_left, const unsigned char* __restrict__ tri_ok,
                const float* __restrict__ zs, const float* __restrict__ ws,
                const int* __restrict__ count, int n_tri, int tri_block, int width, int height,
                Sizes sz, float4* __restrict__ rec, float4* __restrict__ gbox,
                int* __restrict__ counts, int* __restrict__ lists,
                int* __restrict__ coarse_lists) {
  launch_dependents();
  const int n_walk = walked(count, n_tri, tri_block);
  const int t = blockIdx.x * BIN_THREADS + threadIdx.x;
  const int lane = threadIdx.x % 32;
  float4 r[REC];
  bool live = false;
  if (t < n_walk) {  // every load at once; the live flag picks after
    live = tri_ok[t];
    const float* a = adj + 9 * (size_t)t;
    const float* z = zs + 3 * (size_t)t;
    const float* w = ws + 3 * (size_t)t;
    const unsigned char* tl = top_left + 3 * (size_t)t;
    r[0] = make_float4(a[0], a[1], a[2], a[3]);
    r[1] = make_float4(a[4], a[5], a[6], a[7]);
    r[2] = make_float4(a[8], z[0], z[1], z[2]);
    r[3] = make_float4(w[0], w[1], w[2],
                       __uint_as_float((tl[0] ? 1u : 0u) | (tl[1] ? 2u : 0u) |
                                       (tl[2] ? 4u : 0u)));
    r[4] = make_float4(bb[4 * (size_t)t], bb[4 * (size_t)t + 1], bb[4 * (size_t)t + 2],
                       bb[4 * (size_t)t + 3]);
  }
  // the counters are zeroed once the zeroing kernel is done: every thread
  // waits for it, so that this grid's end means theirs too
  wait_prerequisites();
  if (t - lane >= n_walk) return;  // the whole warp: past the walked blocks
  if (!live) {  // dead: nothing, an empty box
#pragma unroll
    for (int i = 0; i < REC - 1; ++i) r[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r[4] = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  }
#pragma unroll
  for (int i = 0; i < REC; ++i) rec[(size_t)t * REC + i] = r[i];
  // the group box: fminf / fmaxf drop a NaN bound (its triangle covers nothing)
  float4 b = r[4];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.x = fminf(b.x, __shfl_xor_sync(FULL, b.x, o));
    b.y = fmaxf(b.y, __shfl_xor_sync(FULL, b.y, o));
    b.z = fminf(b.z, __shfl_xor_sync(FULL, b.z, o));
    b.w = fmaxf(b.w, __shfl_xor_sync(FULL, b.w, o));
  }
  if (lane == 0) gbox[t / GROUP] = b;
  // the cell lists: fine cells [cx0, cx1] x [cy0, cy1], n_cells of them
  int cx0 = 0, cx1 = -1, cy0 = 0, cy1 = -1;
  if (!(live && cell_span(r[4].x, r[4].y, width, CW, cx0, cx1) &&
        cell_span(r[4].z, r[4].w, height, CH, cy0, cy1))) {
    cx1 = cx0 - 1;
  }
  int nx = cx1 - cx0 + 1, n_cells = nx * (cy1 - cy0 + 1);
  const bool by_warp = n_cells > LANE_CELLS;
  if (!by_warp) {
    for (int k = 0; k < n_cells; ++k) {  // one atomic per cell among the lanes here
      const int c = (cy0 + k / nx) * sz.cells_x + cx0 + k % nx;
      const unsigned peers = __match_any_sync(__activemask(), c);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&counts[c], __popc(peers));
      const int slot = __shfl_sync(peers, base, leader) + __popc(peers & ((1u << lane) - 1));
      if (slot < sz.cap) lists[(size_t)c * sz.cap + slot] = t;
    }
  }
  // a triangle of more fine cells: the warp lists those of all its lanes
  // at once, a cell a lane (in the coarse cells past FINE_MOST fine ones)
  const bool coarse = n_cells > FINE_MOST;
  if (coarse) {
    cx0 = cx0 * CW / COARSE;
    cx1 = cx1 * CW / COARSE;
    cy0 = cy0 * CH / COARSE;
    cy1 = cy1 * CH / COARSE;
    nx = cx1 - cx0 + 1;
    n_cells = nx * (cy1 - cy0 + 1);
  }
  const int mine = by_warp ? n_cells : 0;
  int first = mine;  // the lanes' cells in a row: this lane's first, exclusive scan
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, first, o);
    if (lane >= o) first += v;
  }
  const int total = __shfl_sync(FULL, first, 31);
  first -= mine;
  for (int q0 = 0; q0 < total; q0 += 32) {
    const int q = q0 + lane;
    int src = 0;  // the last lane whose first cell is at most q
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(FULL, first, src + step) <= q) src += step;
    }
    const int k = q - __shfl_sync(FULL, first, src), tri = __shfl_sync(FULL, t, src);
    const int x0 = __shfl_sync(FULL, cx0, src), y0 = __shfl_sync(FULL, cy0, src);
    const int w = __shfl_sync(FULL, nx, src);
    const bool to_coarse = __shfl_sync(FULL, coarse, src);
    if (q >= total) continue;
    const int c = (y0 + k / w) * (to_coarse ? sz.coarse_x : sz.cells_x) + x0 + k % w;
    const int cap = to_coarse ? sz.coarse_cap : sz.cap;
    const int slot = atomicAdd(&counts[to_coarse ? sz.cells + c : c], 1);
    if (slot < cap) (to_coarse ? coarse_lists : lists)[(size_t)c * cap + slot] = tri;
  }
}

template <bool BARY, int AX, int AY, int K>
__global__ void __launch_bounds__(THREADS, 5)
scan_walk_kernel(const float4* __restrict__ rec, const float4* __restrict__ gbox,
                 const int* __restrict__ counts, const int* __restrict__ lists,
                 const int* __restrict__ coarse_lists, Sizes sz,
                 const int* __restrict__ count, int n_tri, int tri_block, int width, int height,
                 float* __restrict__ depth, int* __restrict__ tri_id, float* __restrict__ bary) {
  __shared__ __align__(16) float4 s_rec[2][STAGE * REC];
  __shared__ int s_idx[LIST];  // the triangles of this batch of the cell's list
  __shared__ int s_n;
  __shared__ float s_z[K][AX * AY * 32], s_l[K][3][AX * AY * 32];  // the K warps' results
  __shared__ int s_id[K][AX * AY * 32];
  constexpr int RW = LX * AX, RH = LY * AY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int area = warp / K, part = warp % K;
  const int rx0 = blockIdx.x * RW, ry0 = blockIdx.y * RH;
  const int wx0 = rx0 + (area % AX) * LX, wy0 = ry0 + (area / AX) * LY;
  const int x = wx0 + lane % LX, y = wy0 + lane / LX;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  // the pixel centres of the region and of the warp's area
  const float bx0 = (float)rx0 + 0.5f, bx1 = (float)(min(rx0 + RW, width) - 1) + 0.5f;
  const float by0 = (float)ry0 + 0.5f, by1 = (float)(min(ry0 + RH, height) - 1) + 0.5f;
  const float vx0 = (float)wx0 + 0.5f, vx1 = (float)(min(wx0 + LX, width) - 1) + 0.5f;
  const float vy0 = (float)wy0 + 0.5f, vy1 = (float)(min(wy0 + LY, height) - 1) + 0.5f;
  const bool warp_in = wx0 < width && wy0 < height;
  const int n_groups = (walked(count, n_tri, tri_block) + GROUP - 1) / GROUP;
  wait_prerequisites();  // the binning is done

  // the region's lists: its fine cell's, then its coarse cell's; a list
  // past its capacity has the region walked from the group boxes instead
  const int cell = (ry0 / CH) * sz.cells_x + rx0 / CW;
  const int ccell = (ry0 / COARSE) * sz.coarse_x + rx0 / COARSE;
  const int n_fine = counts[cell], n_coarse = counts[sz.cells + ccell];
  const int listed = n_fine + n_coarse;
  const bool from_boxes = n_fine > sz.cap || n_coarse > sz.coarse_cap;
  const int n_batches =
      from_boxes ? (n_groups + BOX_BATCH - 1) / BOX_BATCH : (listed + LIST - 1) / LIST;
  const int* fine = lists + (size_t)cell * sz.cap;
  const int* coarse = coarse_lists + (size_t)ccell * sz.coarse_cap;

  float best_z = DEPTH_CLEAR, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int best = NO_TRIANGLE;
  for (int batch = 0; batch < n_batches; ++batch) {
    __syncthreads();  // the previous batch has been read
    if (from_boxes) {  // the triangles of every group whose box reaches the region
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      const int g = batch * BOX_BATCH + threadIdx.x;
      if (threadIdx.x < BOX_BATCH && g < n_groups && overlaps(gbox[g], bx0, bx1, by0, by1)) {
        const int at = atomicAdd(&s_n, GROUP);
        for (int j = 0; j < GROUP; ++j) s_idx[at + j] = g * GROUP + j;
      }
    } else {
      const int n = min(LIST, listed - batch * LIST);
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int e = batch * LIST + i;
        s_idx[i] = e < n_fine ? fine[e] : coarse[e - n_fine];
      }
      if (threadIdx.x == 0) s_n = n;
    }
    __syncthreads();
    const int n = s_n;
    const int n_stages = (n + STAGE - 1) / STAGE;
    auto stage = [&](int s) {  // gather stage s's records into buffer s & 1
      float4* dst = s_rec[s & 1];
      for (int e = threadIdx.x; e < STAGE * REC; e += THREADS) {
        const int k = s * STAGE + e / REC;
        if (k < n) cp_async16(dst + e, rec + (size_t)s_idx[k] * REC + e % REC);
      }
      cp_async_commit();
    };
    if (n_stages > 0) stage(0);
    for (int s = 0; s < n_stages; ++s) {
      if (s + 1 < n_stages) {
        stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* R = s_rec[s & 1];
      // the warp's own hits: the staged triangles whose bbox reaches its pixels
#pragma unroll 1
      for (int word = 0; word < STAGE / 32 && warp_in; ++word) {
        const int k0 = s * STAGE + word * 32;
        unsigned m = __ballot_sync(
            FULL, k0 + lane < n && overlaps(R[(word * 32 + lane) * REC + 4], vx0, vx1, vy0, vy1));
        for (int i = 0; i < part && m; ++i) m &= m - 1;  // this warp's hits: every K-th from its part
        while (m) {
          const int bit = __ffs(m) - 1;
          for (int i = 0; i < K && m; ++i) m &= m - 1;
          const int id = s_idx[k0 + bit];
          float lam0, lam1, lam2, z;
          if (covers(R + (word * 32 + bit) * REC, px, py, lam0, lam1, lam2, z) &&
              (z < best_z || (z == best_z && id < best))) {
            best_z = z;
            best = id;
            if (BARY) {
              l0 = lam0;
              l1 = lam1;
              l2 = lam2;
            }
          }
        }
      }
      __syncthreads();  // the stage has been read before its buffer is refilled
    }
  }

  if (K > 1) {  // the K warps of an area merge: the least (z, id)
    const int q = area * 32 + lane;
    s_z[part][q] = best_z;
    s_id[part][q] = best;
    s_l[part][0][q] = l0;
    s_l[part][1][q] = l1;
    s_l[part][2][q] = l2;
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int j = 1; j < K; ++j) {
      const float z = s_z[j][q];
      const int id = s_id[j][q];
      if (z < best_z || (z == best_z && id < best)) {
        best_z = z;
        best = id;
        l0 = s_l[j][0][q];
        l1 = s_l[j][1][q];
        l2 = s_l[j][2][q];
      }
    }
  }
  if (x >= width || y >= height) return;
  const size_t o = (size_t)y * width + x, plane = (size_t)width * height;
  depth[o] = best_z;
  tri_id[o] = best;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  if (BARY && best != NO_TRIANGLE) {
    const float s = __fadd_rn(__fadd_rn(l0, l1), l2);
    const float d = s != 0.0f ? s : 1.0f;
    b0 = __fdiv_rn(l0, d);
    b1 = __fdiv_rn(l1, d);
    b2 = __fdiv_rn(l2, d);
  }
  bary[o] = b0;
  bary[plane + o] = b1;
  bary[2 * plane + o] = b2;
}

}  // namespace

// The scratch bytes of a call over n_tri triangles into a width x height
// image (the wrapper allocates them).
extern "C" long long rtt_scan_raster_scratch(int n_tri, int width, int height) {
  return sizes(n_tri, width, height).bytes;
}

namespace {

int sm_count() {  // of the current device, read once
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

bool split_shape(int width, int height) {
  const long long wide = (long long)((width + LX * WIDE_AX - 1) / (LX * WIDE_AX)) *
                         ((height + LY * WIDE_AY - 1) / (LY * WIDE_AY));
  return wide < (long long)SPLIT_BELOW * sm_count();
}

}  // namespace

// The design's sizes of a call over n_tri triangles into a width x height
// image, for the reports: region width and height (a pixel per lane),
// warps per area, cell width and height, the list capacity per fine
// cell, triangles per group box and per stage.
extern "C" void rtt_scan_raster_design(int n_tri, int width, int height, int* out) {
  const bool split = split_shape(width, height);
  const int v[8] = {LX * (split ? SPLIT_AX : WIDE_AX), LY * (split ? SPLIT_AY : WIDE_AY),
                    split ? SPLIT_K : WIDE_K, CW, CH, sizes(n_tri, width, height).cap, GROUP,
                    STAGE};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Launches the three kernels on `stream`; returns
// cudaGetLastError() (0 on success). `count` is a device pointer to the
// soup's int32 count, or null for every block; n_tri is a multiple of
// tri_block. `scratch` (16-byte aligned) holds rtt_scan_raster_scratch's
// bytes: cudaErrorInvalidValue if `scratch_size` is smaller. Writes depth
// (H, W), tri_id (H, W) and bary (3, H, W), zeros without `with_bary`.
extern "C" int rtt_scan_raster(const float* adj, const float* bb, const unsigned char* top_left,
                               const unsigned char* tri_ok, const float* zs, const float* ws,
                               const int* count, int n_tri, int tri_block, int width, int height,
                               int with_bary, void* scratch, long long scratch_size, float* depth,
                               int* tri_id, float* bary, void* stream) {
  if (n_tri < 0 || tri_block <= 0 || n_tri % tri_block || width < 0 || height < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (width == 0 || height == 0) return (int)cudaSuccess;
  const Sizes sz = sizes(n_tri, width, height);
  if ((uintptr_t)scratch % 16 || scratch_size < sz.bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float4* rec = static_cast<float4*>(scratch);
  float4* gbox = rec + (size_t)REC * GROUP * sz.groups;
  int* counts = reinterpret_cast<int*>(gbox + sz.groups);  // fine cells', then coarse cells'
  int* lists = counts + (sz.cells + sz.coarse + 3) / 4 * 4;
  int* coarse_lists = lists + (size_t)sz.cells * sz.cap;
  // the zeroing, then the binning and the walk each launched as the
  // programmatic dependent of the kernel before
  const int n_counts = sz.cells + sz.coarse;
  scan_zero_kernel<<<(n_counts + 1023) / 1024, 1024, 0, s>>>(counts, n_counts);
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  auto config = [&](dim3 grid, int threads) {
    cudaLaunchConfig_t c = {};
    c.gridDim = grid;
    c.blockDim = dim3(threads);
    c.stream = s;
    c.attrs = &dependent;
    c.numAttrs = 1;
    return c;
  };
  if (sz.groups > 0) {
    const cudaLaunchConfig_t c =
        config(dim3((sz.groups * GROUP + BIN_THREADS - 1) / BIN_THREADS), BIN_THREADS);
    const cudaError_t err = cudaLaunchKernelEx(&c, scan_bin_kernel, adj, bb, top_left, tri_ok, zs,
                                               ws, count, n_tri, tri_block, width, height, sz,
                                               rec, gbox, counts, lists, coarse_lists);
    if (err != cudaSuccess) return (int)err;
  }
  auto walk = [&](auto kernel, int rw, int rh) {
    const cudaLaunchConfig_t c = config(dim3((width + rw - 1) / rw, (height + rh - 1) / rh),
                                        THREADS);
    return cudaLaunchKernelEx(&c, kernel, (const float4*)rec, (const float4*)gbox,
                              (const int*)counts, (const int*)lists, (const int*)coarse_lists, sz,
                              count, n_tri, tri_block, width, height, depth, tri_id, bary);
  };
  constexpr int WW = LX * WIDE_AX, WH = LY * WIDE_AY, SW = LX * SPLIT_AX, SH = LY * SPLIT_AY;
  cudaError_t err;
  if (split_shape(width, height)) {
    err = with_bary ? walk(scan_walk_kernel<true, SPLIT_AX, SPLIT_AY, SPLIT_K>, SW, SH)
                    : walk(scan_walk_kernel<false, SPLIT_AX, SPLIT_AY, SPLIT_K>, SW, SH);
  } else {
    err = with_bary ? walk(scan_walk_kernel<true, WIDE_AX, WIDE_AY, WIDE_K>, WW, WH)
                    : walk(scan_walk_kernel<false, WIDE_AX, WIDE_AY, WIDE_K>, WW, WH);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
