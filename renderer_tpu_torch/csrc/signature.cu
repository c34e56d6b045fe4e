// Kernel 8: the cached shadow atlas's change-detection signatures
// (ops/shadow.py shadow_signature) for Hopper (sm_90a): per atlas unit (a
// slot, or one of a directional slot's K bands) the instances its frustum
// can see, folded with fixed weights into SIG_C salted sums.
//
// Not a TPU kernel: the JAX package leaves this loop to XLA
// (renderer_tpu/ops/shadow.py shadow_signature). The plain PyTorch version
// is ops/shadow.py:shadow_signature, one coarse_cull per live slot and a
// fold of small ATen kernels (~900 launches a call at 16 slots of 16
// bands). The unit table and the band frustums' planes stay plain PyTorch
// (ops/shadow.py signature_units and signature_planes: one batched call
// for all units), so the planes are the cull's own bits.
//
// What bounds it on the H100: at 16 slots x 16 bands x 10000 instances,
// 2.56 M box-frustum tests of 13 FP32 operations a plane, up to the first
// plane the box lies outside, with the world boxes, profiles and fold ~49
// operations a unit and instance (chip_smoke's signature_ops: ~0.13 GFLOP,
// ~1.9 us at 67 TFLOP/s) over ~1 MB of model rows, mesh boxes, weights and
// planes (~0.3 us at 3.35 TB/s): the plain version's ~3.4 ms is launches
// and latency, so the aim is two launches that fill the card.
//
// Design: two kernels a group of up to GROUP slots (one group at 16 slots).
// signature_tiles_kernel: a CTA per (live slot, tile of THREADS instances),
// one thread an instance. A thread loads its model row, mesh box and alive
// flag once and computes the world box and its SIG_C profiles once; then,
// for each chunk of up to 32 of the slot's units, the CTA stages the
// chunk's plane sets (units x views x 6 planes) in shared memory, each
// thread tests its box against each unit's frustums (a point slot's unit is
// the union of its six cube faces), stopping at the first plane it lies
// outside, the band's bottom and top first, and writes one visibility bit a
// unit to shared memory. Then warp w sums units w, w + 8, ...: each lane
// adds vis x profile over every 32nd instance of the tile, a shuffle tree
// adds the lanes, and lane 0 writes the (unit, tile, component) partial.
// signature_fold_kernel: a warp per (slot, unit, component) adds its
// light's face matrices times their weights and the tiles' partials, each
// as lane-strided sums and a shuffle tree, then the kind term, or writes
// the wrapper's sentinels for an empty slot and a unit the slot does not
// track. No atomics, every sum in a fixed order: the same inputs give the
// same bits on every call and replay. Any number of slots and units: the
// slot table goes by value a group at a time, and shared memory holds one
// chunk of units (at most ~23 KB a CTA).
//
// Exactness: each (unit, instance) visibility equals coarse_cull's bit for
// bit (ops/geometry.py _world_aabb_cols and _outside_frustum): the mesh box
// through mesh_id, c_loc = (min + max) * 0.5, e_loc = (max - min) * 0.5,
// cw = ((m0 c0 + m1 c1) + m2 c2) + m3, ew with |m|, per plane
// dist = ((a cw0 + b cw1) + c cw2) + d, rr with |a|, |b|, |c|, outside when
// dist + rr < 0, visible when alive and inside every plane of a view; every
// product and sum __fmul_rn / __fadd_rn in that order (and -fmad=false).
// The fold sums in its own order: the values are not the plain version's,
// the decisions they drive (a unit is dirty when its signature changed)
// are. vis x profile is a product, as the plain version's, so a NaN in a
// row (even of an instance not seen) makes the unit's sum NaN there too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // instances per tile, one a thread
constexpr int WARPS = THREADS / 32;
constexpr int SIG_C = 3;  // salted components (ops/shadow.py SIG_C)
constexpr int PLANES = 6;  // per frustum: left, right, bottom, top, near, far
constexpr int PLANE_FLOATS = PLANES * 4;
constexpr int GROUP = 64;  // slots a launch's table holds (by value)
constexpr int CHUNK = 32;  // units whose planes shared memory holds at a time, a bit each
constexpr int MAT_FLOATS = 6 * 16;  // a light's six face matrices
constexpr unsigned FULL = 0xffffffffu;

// The unit table of slots base .. base + count - 1, static on the host
// (ops/shadow.py signature_units), per slot of the group; `live` lists the
// group's slots with a light, in slot order.
struct Slots {
  int base, count;
  int live[GROUP];
  int light[GROUP];  // the slot's light, -1 for an empty slot
  int units[GROUP];  // units it tracks: K bands, or 1
  int views[GROUP];  // frustums per unit: 1, or 6 cube faces
  int view0[GROUP];  // its first frustum in the plane table
  float kind[GROUP];  // its kind term
};

struct Params {
  const float* model;     // (n, 16) row-major model matrices
  const int* mesh_id;     // (n,)
  const float* box_min;   // (meshes, 3)
  const float* box_max;   // (meshes, 3)
  const bool* alive;      // (n,)
  const float* planes;    // (views, 6, 4) normalised frustum planes
  const float* light_mats;  // (lights, 6, 4, 4)
  const float* wk[SIG_C];   // (16,) model column weights
  const float* wr[SIG_C];   // (n,) model fold weights
  const float* wm[SIG_C];   // (n,) mesh id weights
  const float* wc[SIG_C];   // (n,) count terms
  const float* wl[SIG_C];   // (6, 16) light matrix weights
  float* partial;           // (n_slots, n_units, tiles, SIG_C) scratch
  float* out;               // (n_slots, n_units, SIG_C)
  int n, tiles, n_slots, n_units, n_mesh;
  float empty_first, empty_rest;  // the sentinels: an empty slot's unit 0, every other
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// Whether the box (centre cw, half extent ew) lies inside every plane of
// frustum f: coarse_cull's test, which is an AND over the planes, so it
// stops at the first plane the box lies wholly outside. The band-limiting
// planes (bottom, top) come first: a band rejects most boxes there.
__device__ __forceinline__ bool inside(const float* f, const float* cw, const float* ew) {
#pragma unroll
  for (int q = 0; q < PLANES; ++q) {
    const float* pq = f + 4 * (q < 2 ? q + 2 : q < 4 ? q - 2 : q);  // planes 2, 3, 0, 1, 4, 5
    const float a = pq[0], b = pq[1], c = pq[2], d = pq[3];
    const float dist = add(add(add(mul(a, cw[0]), mul(b, cw[1])), mul(c, cw[2])), d);
    const float rr = add(add(mul(fabsf(a), ew[0]), mul(fabsf(b), ew[1])), mul(fabsf(c), ew[2]));
    if (add(dist, rr) < 0.f) return false;
  }
  return true;
}

// A warp's sum of x over its lanes by a fixed shuffle tree (lane 0 holds it).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = add(x, __shfl_down_sync(FULL, x, off));
  return x;
}

__global__ void __launch_bounds__(THREADS)
signature_tiles_kernel(const Params p, const Slots s) {
  const int g = s.live[blockIdx.y], slot = s.base + g;
  const int tile = blockIdx.x;
  const int units = s.units[g], views = s.views[g];
  const int chunk_planes = (units < CHUNK ? units : CHUNK) * views * PLANE_FLOATS;
  extern __shared__ float sh[];
  float* pl = sh;                           // a chunk's plane sets
  float* wk = pl + chunk_planes;            // SIG_C x 16 column weights
  float* prof_s = wk + SIG_C * 16;          // SIG_C x THREADS profiles
  unsigned* mask_s = reinterpret_cast<unsigned*>(prof_s + SIG_C * THREADS);  // THREADS masks
  if (threadIdx.x < SIG_C * 16) wk[threadIdx.x] = p.wk[threadIdx.x / 16][threadIdx.x % 16];
  __syncthreads();

  const int i = tile * THREADS + threadIdx.x;
  bool alive = false;
  float cw[3] = {0.f, 0.f, 0.f}, ew[3] = {0.f, 0.f, 0.f}, prof[SIG_C] = {0.f, 0.f, 0.f};
  if (i < p.n) {
    float m[16];
    const float4* row = reinterpret_cast<const float4*>(p.model + (size_t)i * 16);
    for (int q = 0; q < 4; ++q) {
      const float4 v = row[q];
      m[4 * q] = v.x, m[4 * q + 1] = v.y, m[4 * q + 2] = v.z, m[4 * q + 3] = v.w;
    }
    const int id = p.mesh_id[i];
    const int mesh = id < 0 ? id + p.n_mesh : id;  // a negative index counts from the end
    alive = p.alive[i];
    float c[3], e[3];
    for (int k = 0; k < 3; ++k) {
      const float lo = p.box_min[mesh * 3 + k], hi = p.box_max[mesh * 3 + k];
      c[k] = mul(add(lo, hi), 0.5f);
      e[k] = mul(__fsub_rn(hi, lo), 0.5f);
    }
    for (int r = 0; r < 3; ++r) {
      const float* mr = m + 4 * r;
      cw[r] = add(add(add(mul(mr[0], c[0]), mul(mr[1], c[1])), mul(mr[2], c[2])), mr[3]);
      ew[r] = add(add(mul(fabsf(mr[0]), e[0]), mul(fabsf(mr[1]), e[1])),
                  mul(fabsf(mr[2]), e[2]));
    }
    const float mid = (float)id;
    for (int cc = 0; cc < SIG_C; ++cc) {
      float dot = 0.f;
      for (int j = 0; j < 16; ++j) dot = add(dot, mul(m[j], wk[cc * 16 + j]));
      prof[cc] = add(add(mul(dot, p.wr[cc][i]), mul(mid, p.wm[cc][i])), p.wc[cc][i]);
    }
  }
  for (int cc = 0; cc < SIG_C; ++cc) prof_s[cc * THREADS + threadIdx.x] = prof[cc];

  // units in chunks of CHUNK: the CTA stages the chunk's planes, a thread
  // writes its instance's visibility bits, then warp w sums units w,
  // w + WARPS, ...: lane l takes the instances l, l + 32, ... in order,
  // then the shuffle tree
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u0 = 0; u0 < units; u0 += CHUNK) {
    const int chunk = units - u0 < CHUNK ? units - u0 : CHUNK;
    const float* src = p.planes + ((size_t)s.view0[g] + (size_t)u0 * views) * PLANE_FLOATS;
    for (int k = threadIdx.x; k < chunk * views * PLANE_FLOATS; k += THREADS) pl[k] = src[k];
    __syncthreads();
    unsigned bits = 0;
    if (alive) {
      for (int u = 0; u < chunk; ++u) {
        bool vis = false;
        for (int v = 0; v < views && !vis; ++v)
          vis = inside(pl + (u * views + v) * PLANE_FLOATS, cw, ew);
        bits |= (unsigned)vis << u;
      }
    }
    mask_s[threadIdx.x] = bits;
    __syncthreads();
    for (int u = warp; u < chunk; u += WARPS) {
      float x[SIG_C] = {0.f, 0.f, 0.f};
      for (int j = lane; j < THREADS; j += 32) {
        const float visf = (mask_s[j] >> u) & 1u ? 1.f : 0.f;
        for (int cc = 0; cc < SIG_C; ++cc) x[cc] = add(x[cc], mul(visf, prof_s[cc * THREADS + j]));
      }
      for (int cc = 0; cc < SIG_C; ++cc) {
        const float sum = warp_sum(x[cc]);
        if (lane == 0)
          p.partial[(((size_t)slot * p.n_units + u0 + u) * p.tiles + tile) * SIG_C + cc] = sum;
      }
    }
    __syncthreads();
  }
}

// A warp per output (slot, unit, component) of the group: the light's face
// matrices times their weights and the tiles' partials, each a strided sum
// per lane and a shuffle tree, then (light + kind) + partials.
__global__ void signature_fold_kernel(const Params p, const Slots s) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (t >= s.count * p.n_units * SIG_C) return;
  const int g = t / (p.n_units * SIG_C), u = (t / SIG_C) % p.n_units, cc = t % SIG_C;
  const size_t o = (size_t)s.base * p.n_units * SIG_C + t;
  const int li = s.light[g];
  if (li < 0 || u >= s.units[g]) {
    if (lane == 0) p.out[o] = li < 0 && u == 0 ? p.empty_first : p.empty_rest;
    return;
  }
  const float* m = p.light_mats + (size_t)li * MAT_FLOATS;
  const float* w = p.wl[cc];
  float light = 0.f;
  for (int k = lane; k < MAT_FLOATS; k += 32) light = add(light, mul(m[k], w[k]));
  const float* part = p.partial + ((size_t)(s.base + g) * p.n_units + u) * p.tiles * SIG_C + cc;
  float acc = 0.f;
  for (int k = lane; k < p.tiles; k += 32) acc = add(acc, part[k * SIG_C]);
  light = warp_sum(light);
  acc = warp_sum(acc);
  if (lane == 0) p.out[o] = add(add(light, s.kind[g]), acc);
}

}  // namespace

// Launches kernel 8 on `stream`; returns cudaGetLastError() (0 on success).
// `ptrs` (device pointers) in ops/shadow.py shadow_signature_kernel's order:
// model, mesh_id, box_min, box_max, alive, planes, light_mats, then per
// component wk, wr, wm, wc, wl (SIG_C each, component-major within a
// field), partial, out. `ints`: n, tiles, n_slots, n_units, meshes, then
// per slot its light, units, views and first view. `floats`: the two sentinels,
// then per slot its kind term.
extern "C" int rtt_signature(const uint64_t* ptrs, const int* ints, const float* floats,
                             void* stream) {
  Params p;
  p.model = (const float*)ptrs[0], p.mesh_id = (const int*)ptrs[1];
  p.box_min = (const float*)ptrs[2], p.box_max = (const float*)ptrs[3];
  p.alive = (const bool*)ptrs[4], p.planes = (const float*)ptrs[5];
  p.light_mats = (const float*)ptrs[6];
  for (int c = 0; c < SIG_C; ++c) {
    p.wk[c] = (const float*)ptrs[7 + c], p.wr[c] = (const float*)ptrs[7 + SIG_C + c];
    p.wm[c] = (const float*)ptrs[7 + 2 * SIG_C + c], p.wc[c] = (const float*)ptrs[7 + 3 * SIG_C + c];
    p.wl[c] = (const float*)ptrs[7 + 4 * SIG_C + c];
  }
  p.partial = (float*)ptrs[7 + 5 * SIG_C], p.out = (float*)ptrs[8 + 5 * SIG_C];
  p.n = ints[0], p.tiles = ints[1], p.n_slots = ints[2], p.n_units = ints[3];
  p.n_mesh = ints[4];
  p.empty_first = floats[0], p.empty_rest = floats[1];
  const cudaStream_t st = (cudaStream_t)stream;
  for (int base = 0; base < p.n_slots; base += GROUP) {
    Slots s;
    s.base = base;
    s.count = p.n_slots - base < GROUP ? p.n_slots - base : GROUP;
    int n_live = 0, smem_max = 0;
    for (int g = 0; g < GROUP; ++g) {
      const bool on = g < s.count;
      const int* e = ints + 5 + 4 * (base + g);
      s.light[g] = on ? e[0] : -1;
      s.units[g] = on ? e[1] : 0;
      s.views[g] = on ? e[2] : 0;
      s.view0[g] = on ? e[3] : 0;
      s.kind[g] = on ? floats[2 + base + g] : 0.f;
      s.live[g] = 0;
      if (s.light[g] < 0) continue;
      s.live[n_live++] = g;
      const int smem = ((s.units[g] < CHUNK ? s.units[g] : CHUNK) * s.views[g] * PLANE_FLOATS +
                        SIG_C * 16 + (SIG_C + 1) * THREADS) * (int)sizeof(float);
      smem_max = smem > smem_max ? smem : smem_max;
    }
    if (n_live > 0 && p.tiles > 0)
      signature_tiles_kernel<<<dim3(p.tiles, n_live), THREADS, smem_max, st>>>(p, s);
    const int total = s.count * p.n_units * SIG_C;
    signature_fold_kernel<<<(total * 32 + 255) / 256, 256, 0, st>>>(p, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
