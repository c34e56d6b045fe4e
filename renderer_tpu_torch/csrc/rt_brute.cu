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
// triangle) pairs, each test as far as it is needed (u, then v, then t:
// 8 to 26 operations), early exit aside; the bytes are the origins, the
// plane and 53 bytes per walked triangle. Its cost must follow the soup's
// count, which only the device knows.
//
// Design: one launch per call. A CTA owns a TX x TY tile of the receiver
// image, R receivers per lane, and its WARPS warps each walk all of them
// against their own share of each block's triangles (every WARPS-th), so
// a frame of 65536 receivers still fills the card (512 CTAs of 8 warps).
// Each block of 128 triangles is staged by cp.async (4-byte copies that
// repack the setup into four float4 per triangle: u's vector and
// constant, v's, t's, f) into one of two shared buffers while the other
// is walked.
// - The cull: a warp's lanes first test its share of the block, a
//   triangle a lane, against the bounding box of the tile's origins: u,
//   v, u + v and t are affine in the origin, so their extremes over the
//   box bound every receiver's. A triangle is culled only when a bound
//   misses its test by more than 64 units of roundoff of the sums'
//   magnitudes (u + v by 1e-5 more), and only when those magnitudes are
//   finite: the rounded test of every receiver in the box then fails too,
//   so the plane is the same bits. A tile of the image keeps the box
//   small, so most triangles' shadows miss it.
// - The test: a lane reads a kept triangle with float4 broadcasts for its
//   R receivers and computes u and v for each without a branch; t only
//   for a warp with a receiver inside the triangle (u, v >= 0, u + v <=
//   1), so the hit decides the same as the plain version's full test.
// - The result is an OR, so any order of pairs gives the same plane: after
//   each block the warps merge their occluded receivers in shared memory
//   (a receiver one warp found occluded is skipped by all), a warp leaves
//   a block once all its receivers are occluded, and the CTA leaves the
//   walk once every receiver of it is.
//
// Exactness against the plain version (bit for bit): every product and sum
// uses __fmul_rn / __fadd_rn in its order, s = ((o0 c0 + o1 c1) + o2 c2) -
// const, u, v, t = s * f; no FMA contraction (built with -fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;    // triangles per block of the count bound, and per stage
constexpr int WARPS = 8;      // warps per CTA, each on every WARPS-th triangle
constexpr int THREADS = 32 * WARPS;
constexpr int TX = 16, TY = 8;  // a CTA's receivers: a lane's R of them two rows apart
constexpr int R = TX * TY / 32;  // receivers per lane
constexpr int TRI_FLOATS = 13;  // 9 vector components, 3 constants, f
constexpr float EPS = 1e-3f;  // ops/rt.py EPS: the least hit distance
constexpr float ROUNDOFF = 64.0f * 5.9604645e-8f;  // the cull's margin per unit of magnitude
constexpr float UV_MARGIN = 1e-5f;
constexpr float TINY = 1e-30f;  // a bound this close to 0 might round to a zero
constexpr unsigned FULL = 0xffffffffu;
static_assert(TX == 16 && R * 32 == TX * TY && BLOCK % WARPS == 0 && BLOCK / WARPS <= 32,
              "a lane's receivers, a warp's share of a block");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
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

// s . c - k, then times f
__device__ __forceinline__ float quantity(const float (&o)[3], float4 c, float f) {
  return __fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(o[0], c.x), __fmul_rn(o[1], c.y)),
                                       __fmul_rn(o[2], c.z)),
                             c.w),
                   f);
}

// Over origins o in the box [lo, hi]: the least and the most of the affine
// (o . c - k) f, and the magnitude (sum |o_i c_i| + |k|) |f| that bounds
// its rounding.
__device__ __forceinline__ void extremes(float3 lo, float3 hi, float4 c, float f, float& least,
                                         float& most, float& size) {
  const float ax = c.x * f, ay = c.y * f, az = c.z * f, k = c.w * f;
  least = fminf(lo.x * ax, hi.x * ax) + fminf(lo.y * ay, hi.y * ay) +
          fminf(lo.z * az, hi.z * az) - k;
  most = fmaxf(lo.x * ax, hi.x * ax) + fmaxf(lo.y * ay, hi.y * ay) +
         fmaxf(lo.z * az, hi.z * az) - k;
  size = fmaxf(fabsf(lo.x), fabsf(hi.x)) * fabsf(ax) +
         fmaxf(fabsf(lo.y), fabsf(hi.y)) * fabsf(ay) +
         fmaxf(fabsf(lo.z), fabsf(hi.z)) * fabsf(az) + fabsf(k);
}

// Whether no origin in [lo, hi] can hit the triangle under the rounded
// test: u < 0, v < 0, u + v > 1 or t <= EPS over the whole box, by more
// than the margins (never when a magnitude is not finite).
__device__ __forceinline__ bool culled(float3 lo, float3 hi, float4 cu, float4 cv, float4 ct,
                                       float f) {
  float u0, u1, su, v0, v1, sv, t0, t1, st, w0, w1, sw;
  extremes(lo, hi, cu, f, u0, u1, su);
  extremes(lo, hi, cv, f, v0, v1, sv);
  extremes(lo, hi, ct, f, t0, t1, st);
  extremes(lo, hi, make_float4(cu.x + cv.x, cu.y + cv.y, cu.z + cv.z, cu.w + cv.w), f, w0, w1,
           sw);  // u + v, affine too
  if (!(su + sv + st + sw < INFINITY)) return false;
  return u1 + ROUNDOFF * su < -TINY || v1 + ROUNDOFF * sv < -TINY ||
         w0 - ROUNDOFF * (su + sv + sw) - UV_MARGIN > 1.0f || t1 + ROUNDOFF * st < EPS;
}

__global__ void __launch_bounds__(THREADS, 2)
rt_brute_kernel(const float* __restrict__ origin, const float* __restrict__ cvec,
                const float* __restrict__ consts, const float* __restrict__ f,
                const unsigned char* __restrict__ live, const int* __restrict__ count, int n_tri,
                int n_recv, int width, float* __restrict__ lit) {
  // triangle j of buffer b: s_tri[b][j] = (u's vector, const), (v's), (t's), (f, -, -, -)
  __shared__ __align__(16) float4 s_tri[2][BLOCK][4];
  __shared__ __align__(16) unsigned char s_live[2][BLOCK];
  __shared__ unsigned s_occ[R];
  const int n_blocks = n_tri / BLOCK;
  int n_live = n_blocks;
  if (count != nullptr) {
    const long long c = max(0, *count);
    n_live = (int)min((c + BLOCK - 1) / BLOCK, (long long)n_blocks);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_x = (width + TX - 1) / TX, rows = n_recv / width;
  const int x = blockIdx.x % tiles_x * TX + lane % TX;
  const int y0 = blockIdx.x / tiles_x * TY + lane / TX;  // receiver r on row y0 + 2 r
  float o[R][3];
  bool occ[R];  // occluded, or no receiver
  float3 lo = make_float3(INFINITY, INFINITY, INFINITY);
  float3 hi = make_float3(-INFINITY, -INFINITY, -INFINITY);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t p = (size_t)(y0 + 2 * r) * width + x;
    occ[r] = x >= width || y0 + 2 * r >= rows;
    o[r][0] = occ[r] ? 0.0f : origin[p];
    o[r][1] = occ[r] ? 0.0f : origin[n_recv + p];
    o[r][2] = occ[r] ? 0.0f : origin[2 * (size_t)n_recv + p];
    if (!occ[r]) {
      lo = make_float3(fminf(lo.x, o[r][0]), fminf(lo.y, o[r][1]), fminf(lo.z, o[r][2]));
      hi = make_float3(fmaxf(hi.x, o[r][0]), fmaxf(hi.y, o[r][1]), fmaxf(hi.z, o[r][2]));
    }
  }
  // the tile's box (every warp holds the same receivers)
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = make_float3(fminf(lo.x, __shfl_xor_sync(FULL, lo.x, s)),
                     fminf(lo.y, __shfl_xor_sync(FULL, lo.y, s)),
                     fminf(lo.z, __shfl_xor_sync(FULL, lo.z, s)));
    hi = make_float3(fmaxf(hi.x, __shfl_xor_sync(FULL, hi.x, s)),
                     fmaxf(hi.y, __shfl_xor_sync(FULL, hi.y, s)),
                     fmaxf(hi.z, __shfl_xor_sync(FULL, hi.z, s)));
  }
  if (threadIdx.x < R) s_occ[threadIdx.x] = 0u;

  auto stage = [&](int b) {  // copy block b into buffer b & 1, repacked
    float* dst = reinterpret_cast<float*>(s_tri[b & 1]);
    const size_t t0 = (size_t)b * BLOCK;
    for (int e = threadIdx.x; e < TRI_FLOATS * BLOCK; e += THREADS) {
      if (e < 9 * BLOCK) {  // cvec: triangle e / 9, quantity e % 9 / 3, component e % 3
        const int j = e / 9, i = e % 9;
        cp_async4(dst + 16 * j + 4 * (i / 3) + i % 3, cvec + 9 * t0 + e);
      } else if (e < 12 * BLOCK) {  // consts: triangle e' / 3, quantity e' % 3
        const int e2 = e - 9 * BLOCK, j = e2 / 3, q = e2 % 3;
        cp_async4(dst + 16 * j + 4 * q + 3, consts + 3 * t0 + e2);
      } else {
        const int j = e - 12 * BLOCK;
        cp_async4(dst + 16 * j + 12, f + t0 + j);
      }
    }
    if (threadIdx.x < BLOCK / 16) {
      cp_async16(&s_live[b & 1][16 * threadIdx.x], live + t0 + 16 * threadIdx.x);
    }
    cp_async_commit();
  };

  if (n_live > 0) stage(0);
  for (int b = 0; b < n_live; ++b) {
    if (b + 1 < n_live) {
      stage(b + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4(*T)[4] = s_tri[b & 1];
    const unsigned char* L = s_live[b & 1];
    bool done = true;
#pragma unroll
    for (int r = 0; r < R; ++r) done = done && occ[r];
    if (!__all_sync(FULL, done)) {
      // the warp's share, a triangle a lane: the live ones the cull keeps
      bool keep = false;
      if (lane < BLOCK / WARPS) {
        const int j = lane * WARPS + warp;
        keep = L[j] && !culled(lo, hi, T[j][0], T[j][1], T[j][2], T[j][3].x);
      }
      unsigned m = __ballot_sync(FULL, keep);
      while (m) {
        const int j = (__ffs(m) - 1) * WARPS + warp;
        m &= m - 1;
        const float4 cu = T[j][0], cv = T[j][1];
        const float fj = T[j][3].x;
        // u and v for every receiver (no branch); t only where a ray
        // passes inside the triangle, for a warp that has one
        bool inside[R], any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float u = quantity(o[r], cu, fj), v = quantity(o[r], cv, fj);
          inside[r] = !occ[r] && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
          any = any || inside[r];
        }
        if (!__any_sync(FULL, any)) continue;
        const float4 ct = T[j][2];
        done = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (inside[r]) occ[r] = quantity(o[r], ct, fj) > EPS;
          done = done && occ[r];
        }
        if (__all_sync(FULL, done)) break;
      }
    }
    // merge the warps' occluded receivers: a receiver occluded for one is for all
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned m = __ballot_sync(FULL, occ[r]);
      if (lane == 0 && m) atomicOr(&s_occ[r], m);
    }
    __syncthreads();
    done = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      occ[r] = (s_occ[r] >> lane) & 1u;
      done = done && occ[r];
    }
    // every receiver of the CTA occluded: no later triangle changes it; the
    // barrier also keeps the stage until it has been read
    if (__syncthreads_and(done)) break;
  }
  // a CTA that left early may have a copy in flight: wait before exiting
  cp_async_wait<0>();
  if (warp != 0) return;  // every warp holds the merged flags: one writes them
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (x < width && y0 + 2 * r < rows) {
      lit[(size_t)(y0 + 2 * r) * width + x] = occ[r] ? 0.0f : 1.0f;
    }
  }
}

}  // namespace

// The design's sizes, for the reports: receiver tile width and height,
// receivers per lane, warps per CTA, triangles per block.
extern "C" void rtt_rt_brute_design(int* out) {
  const int v[5] = {TX, TY, R, WARPS, BLOCK};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success). origin (3, n_recv): rows of `width` receivers; cvec (n_tri, 3,
// 3), consts (n_tri, 3), f (n_tri,), live (n_tri,) bytes, 16-byte aligned;
// n_tri a multiple of 128; `count` a device pointer to the soup's int32
// count, or null for every block. Writes lit (n_recv,): 1 lit, 0 occluded.
extern "C" int rtt_rt_brute(const float* origin, const float* cvec, const float* consts,
                            const float* f, const unsigned char* live, const int* count,
                            int n_tri, int n_recv, int width, float* lit, void* stream) {
  if (n_tri < 0 || n_tri % BLOCK || n_recv < 0 || width <= 0 || n_recv % width ||
      (uintptr_t)live % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_recv == 0) return (int)cudaSuccess;
  const int tiles = (width + TX - 1) / TX * ((n_recv / width + TY - 1) / TY);
  rt_brute_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(origin, cvec, consts, f, live,
                                                                 count, n_tri, n_recv, width, lit);
  return (int)cudaGetLastError();
}
