// Scan rasterizer for Hopper (sm_90a): every triangle of the soup's first
// ceil(count / tri_block) blocks tested against every pixel, with a running
// (depth, id, barycentrics) result per pixel, bounded by the soup's count
// read on the device.
//
// Not a TPU kernel: the port's counterpart of the block loop that the JAX
// package runs in XLA, renderer_tpu/ops/raster_jax.py:rasterize(count=)
// (its fori_loop over ceil(count / tri_block) blocks, :82-85 and :184).
// The plain PyTorch version is ops/raster_scan.py:scan_raster_plain, and
// the per-triangle setup (edge coefficients, screen bbox, top-left flags,
// the live mask, corner z and w) stays plain PyTorch (scan_inputs), as it
// is XLA code outside the loop in the JAX package.
//
// What bounds it on the H100: the FP32 arithmetic of the (pixel,
// triangle) pairs inside the triangles' bboxes, ~25 operations each (three
// 2-term edge functions, two 3-term dots, a divide and compares); the
// bytes are the five output planes and 23 values per walked triangle. Its
// cost must follow the soup's count: the walk stops at the count's last
// block, which only the device knows (the host reads nothing back).
//
// Design (simple; making it fast is later work): one launch per call, one
// thread per pixel, CTAs of TW x TH pixels. For each chunk of 128 walked
// triangles the first 128 threads of the CTA each test one triangle (live
// and its bbox reaching the CTA's pixel centres) and stage the hits' setup
// in shared memory, struct of arrays, with a 128-bit hit mask (one ballot
// per warp). After a barrier every thread walks the mask in ascending
// triangle order. A triangle whose bbox misses the CTA's extreme pixel
// centres covers none of its pixels (the bbox test is part of coverage),
// so the skip is exact.
// - Ties go to the lowest id: the plain version takes a per-block argmin
//   (lowest id on ties) and then a strict < across blocks; a walk in id
//   order with a strict < keeps the same winner.
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
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 8;    // a CTA's pixels: one row of 32 per warp
constexpr int THREADS = TW * TH;
constexpr int CHUNK = 128;        // triangles staged at once
constexpr float DEPTH_CLEAR = 1.0f;  // ops/raster_spec.py
constexpr int NO_TRIANGLE = -1;
constexpr unsigned FULL = 0xffffffffu;

struct Stage {
  float a[9][CHUNK];   // edge e, coefficient c at a[3e + c]
  float z[3][CHUNK];
  float w[3][CHUNK];
  float bb[4][CHUNK];  // xmin, xmax, ymin, ymax
  unsigned tl[CHUNK];  // top-left flag of edge e at bit e
  unsigned mask[CHUNK / 32];
};

__device__ __forceinline__ float edge_fn(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float dot3(float l0, float l1, float l2, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l0, a), __fmul_rn(l1, b)), __fmul_rn(l2, c));
}

__device__ __forceinline__ bool accept(float lam, unsigned tl, int e) {
  return lam > 0.0f || (lam == 0.0f && ((tl >> e) & 1u));
}

template <bool BARY>
__global__ void __launch_bounds__(THREADS)
scan_raster_kernel(const float* __restrict__ adj, const float* __restrict__ bb,
                   const unsigned char* __restrict__ top_left,
                   const unsigned char* __restrict__ tri_ok, const float* __restrict__ zs,
                   const float* __restrict__ ws, const int* __restrict__ count, int n_tri,
                   int tri_block, int width, int height, float* __restrict__ depth,
                   int* __restrict__ tri_id, float* __restrict__ bary) {
  __shared__ Stage st;
  const int n_blocks = n_tri / tri_block;
  int n_live = n_blocks;
  if (count != nullptr) {
    const long long c = max(0, *count);
    n_live = (int)min((c + tri_block - 1) / tri_block, (long long)n_blocks);
  }
  const int n_walk = n_live * tri_block;

  const int cx0 = blockIdx.x * TW, cy0 = blockIdx.y * TH;
  const int x = cx0 + threadIdx.x % TW, y = cy0 + threadIdx.x / TW;
  const bool in_image = x < width && y < height;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  // the CTA's pixel centres span [bx0, bx1] x [by0, by1]
  const float bx0 = (float)cx0 + 0.5f, bx1 = (float)(min(cx0 + TW, width) - 1) + 0.5f;
  const float by0 = (float)cy0 + 0.5f, by1 = (float)(min(cy0 + TH, height) - 1) + 0.5f;

  float best_z = DEPTH_CLEAR;
  int best = NO_TRIANGLE;
  float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  for (int c0 = 0; c0 < n_walk; c0 += CHUNK) {
    __syncthreads();  // the previous chunk's stage has been read
    if (threadIdx.x < CHUNK) {
      const int k = threadIdx.x, t = c0 + k;
      bool hit = false;
      if (t < n_walk && tri_ok[t]) {
        const float xmin = bb[4 * t], xmax = bb[4 * t + 1];
        const float ymin = bb[4 * t + 2], ymax = bb[4 * t + 3];
        hit = xmin <= bx1 && xmax >= bx0 && ymin <= by1 && ymax >= by0;
        if (hit) {
#pragma unroll
          for (int i = 0; i < 9; ++i) st.a[i][k] = adj[9 * t + i];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            st.z[i][k] = zs[3 * t + i];
            st.w[i][k] = ws[3 * t + i];
          }
          st.bb[0][k] = xmin;
          st.bb[1][k] = xmax;
          st.bb[2][k] = ymin;
          st.bb[3][k] = ymax;
          st.tl[k] = (top_left[3 * t] ? 1u : 0u) | (top_left[3 * t + 1] ? 2u : 0u) |
                     (top_left[3 * t + 2] ? 4u : 0u);
        }
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if ((k & 31) == 0) st.mask[k >> 5] = m;
    }
    __syncthreads();
    if (!in_image) continue;
#pragma unroll 1
    for (int word = 0; word < CHUNK / 32; ++word) {
      unsigned m = st.mask[word];
      while (m) {
        const int k = word * 32 + __ffs(m) - 1;
        m &= m - 1;
        if (!(px >= st.bb[0][k] && px <= st.bb[1][k] && py >= st.bb[2][k] &&
              py <= st.bb[3][k])) {
          continue;
        }
        const unsigned tl = st.tl[k];
        const float lam0 = edge_fn(st.a[0][k], st.a[1][k], st.a[2][k], px, py);
        const float lam1 = edge_fn(st.a[3][k], st.a[4][k], st.a[5][k], px, py);
        const float lam2 = edge_fn(st.a[6][k], st.a[7][k], st.a[8][k], px, py);
        if (!(accept(lam0, tl, 0) && accept(lam1, tl, 1) && accept(lam2, tl, 2))) continue;
        const float w_i = dot3(lam0, lam1, lam2, st.w[0][k], st.w[1][k], st.w[2][k]);
        if (!(w_i > 0.0f)) continue;
        const float z_num = dot3(lam0, lam1, lam2, st.z[0][k], st.z[1][k], st.z[2][k]);
        const float z = __fdiv_rn(z_num, w_i);
        if (z >= 0.0f && z <= 1.0f && z < best_z) {
          best_z = z;
          best = c0 + k;
          if (BARY) {
            l0 = lam0;
            l1 = lam1;
            l2 = lam2;
          }
        }
      }
    }
  }

  if (!in_image) return;
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

// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success). `count` is a device pointer to the soup's int32 count, or null
// for every block; n_tri is a multiple of tri_block. Writes depth (H, W),
// tri_id (H, W) and bary (3, H, W), zeros without `with_bary`.
extern "C" int rtt_scan_raster(const float* adj, const float* bb, const unsigned char* top_left,
                               const unsigned char* tri_ok, const float* zs, const float* ws,
                               const int* count, int n_tri, int tri_block, int width, int height,
                               int with_bary, float* depth, int* tri_id, float* bary,
                               void* stream) {
  if (n_tri < 0 || tri_block <= 0 || n_tri % tri_block || width < 0 || height < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (width == 0 || height == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH);
  if (with_bary) {
    scan_raster_kernel<true><<<grid, THREADS, 0, s>>>(adj, bb, top_left, tri_ok, zs, ws, count,
                                                      n_tri, tri_block, width, height, depth,
                                                      tri_id, bary);
  } else {
    scan_raster_kernel<false><<<grid, THREADS, 0, s>>>(adj, bb, top_left, tri_ok, zs, ws, count,
                                                       n_tri, tri_block, width, height, depth,
                                                       tri_id, bary);
  }
  return (int)cudaGetLastError();
}
