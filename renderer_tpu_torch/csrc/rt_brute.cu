// Brute-force ray-traced shadows of a directional light for Hopper
// (sm_90a): every receiver's ray against every live triangle of the soup's
// first ceil(count / 128) blocks (Möller–Trumbore any-hit), bounded by the
// soup's count read on the device.
//
// Not a TPU kernel: the port's counterpart of the block loop that the JAX
// package runs in XLA, renderer_tpu/ops/rt.py:ray_shadow_directional
// (its fori_loop over ceil(count / block) blocks, :82 and :99). The plain
// PyTorch version is ops/rt.py:rt_brute_plain; the per-triangle setup (the
// three vectors d x e2, e1 x d, e1 x e2 as `cvec`, their dots with v0 as
// `consts`, f = 1 / det and the live mask) and the receivers' offset
// origins stay plain PyTorch, as they are XLA code outside the loop there.
//
// What bounds it on the H100: the FP32 arithmetic of the (receiver,
// triangle) pairs, ~25 operations each (three 3-term dots less a constant,
// three products, a sum and five compares), early exit aside; the bytes
// are the origins, the plane and 14 values per walked triangle. Its cost
// must follow the soup's count, which only the device knows.
//
// Design (simple; making it fast is later work): one launch per call, one
// thread per receiver, CTAs of 256. For each chunk of 128 walked triangles
// the first 128 threads each stage one live triangle's setup in shared
// memory (struct of arrays) with a 128-bit live mask (one ballot per
// warp); after a barrier every thread walks the mask. The result is an
// OR, so a thread stops at its first hit, and the CTA leaves the loop once
// every receiver of it is occluded (__syncthreads_and).
//
// Exactness against the plain version (bit for bit): every product and sum
// uses __fmul_rn / __fadd_rn in its order, s = ((o0 c0 + o1 c1) + o2 c2) -
// const, u, v, t = s * f; no FMA contraction (built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK = 128;  // triangles per block of the count bound, and per stage
constexpr float EPS = 1e-3f;  // ops/rt.py EPS: the least hit distance
constexpr unsigned FULL = 0xffffffffu;

struct Stage {
  float c[9][BLOCK];  // quantity q (u, v, t), component j at c[3q + j]
  float k[3][BLOCK];  // the dots of v0 with the three vectors
  float f[BLOCK];
  unsigned mask[BLOCK / 32];
};

__device__ __forceinline__ float sdot(float o0, float o1, float o2, float a, float b, float c,
                                      float k) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(o0, a), __fmul_rn(o1, b)), __fmul_rn(o2, c)), k);
}

__global__ void __launch_bounds__(THREADS)
rt_brute_kernel(const float* __restrict__ origin, const float* __restrict__ cvec,
                const float* __restrict__ consts, const float* __restrict__ f,
                const unsigned char* __restrict__ live, const int* __restrict__ count, int n_tri,
                int n_recv, float* __restrict__ lit) {
  __shared__ Stage st;
  const int n_blocks = n_tri / BLOCK;
  int n_live = n_blocks;
  if (count != nullptr) {
    const long long c = max(0, *count);
    n_live = (int)min((c + BLOCK - 1) / BLOCK, (long long)n_blocks);
  }
  const int n_walk = n_live * BLOCK;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool in_range = p < n_recv;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
  if (in_range) {
    o0 = origin[p];
    o1 = origin[(size_t)n_recv + p];
    o2 = origin[2 * (size_t)n_recv + p];
  }
  bool occluded = false;
  for (int c0 = 0; c0 < n_walk; c0 += BLOCK) {
    if (threadIdx.x < BLOCK) {
      const int j = threadIdx.x, t = c0 + j;
      const bool on = live[t] != 0;
      if (on) {
#pragma unroll
        for (int i = 0; i < 9; ++i) st.c[i][j] = cvec[9 * (size_t)t + i];
#pragma unroll
        for (int i = 0; i < 3; ++i) st.k[i][j] = consts[3 * (size_t)t + i];
        st.f[j] = f[t];
      }
      const unsigned m = __ballot_sync(FULL, on);
      if ((j & 31) == 0) st.mask[j >> 5] = m;
    }
    __syncthreads();
    if (in_range && !occluded) {
#pragma unroll 1
      for (int word = 0; word < BLOCK / 32 && !occluded; ++word) {
        unsigned m = st.mask[word];
        while (m) {
          const int j = word * 32 + __ffs(m) - 1;
          m &= m - 1;
          const float fj = st.f[j];
          const float u = __fmul_rn(sdot(o0, o1, o2, st.c[0][j], st.c[1][j], st.c[2][j],
                                         st.k[0][j]), fj);
          const float v = __fmul_rn(sdot(o0, o1, o2, st.c[3][j], st.c[4][j], st.c[5][j],
                                         st.k[1][j]), fj);
          const float t = __fmul_rn(sdot(o0, o1, o2, st.c[6][j], st.c[7][j], st.c[8][j],
                                         st.k[2][j]), fj);
          if (u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > EPS) {
            occluded = true;
            break;
          }
        }
      }
    }
    // every receiver of the CTA occluded: no later triangle changes it; the
    // barrier also keeps the stage until it has been read
    if (__syncthreads_and(occluded || !in_range)) break;
  }
  if (in_range) lit[p] = occluded ? 0.0f : 1.0f;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success). origin (3, n_recv), cvec (n_tri, 3, 3), consts (n_tri, 3),
// f (n_tri,), live (n_tri,) bytes, n_tri a multiple of 128; `count` a
// device pointer to the soup's int32 count, or null for every block.
// Writes lit (n_recv,): 1 lit, 0 occluded.
extern "C" int rtt_rt_brute(const float* origin, const float* cvec, const float* consts,
                            const float* f, const unsigned char* live, const int* count,
                            int n_tri, int n_recv, float* lit, void* stream) {
  if (n_tri < 0 || n_tri % BLOCK || n_recv < 0) return (int)cudaErrorInvalidValue;
  if (n_recv == 0) return (int)cudaSuccess;
  rt_brute_kernel<<<(n_recv + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      origin, cvec, consts, f, live, count, n_tri, n_recv, lit);
  return (int)cudaGetLastError();
}
