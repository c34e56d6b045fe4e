// Kernel 7: the per-sample shading core of ops/pbr.py for Hopper (sm_90a):
// record gather, barycentrics, base-colour and normal-map taps with
// Toksvig, the shadow maps' 2x2 PCF, GGX + Lambert per light, ambient,
// emissive and the background, one thread a sample.
//
// Not a TPU kernel: the port's counterpart of the shading that the JAX
// package leaves to XLA, renderer_tpu/ops/pbr.py:shade_pbr's `run`. The
// plain PyTorch version is ops/pbr.py:shade_samples_plain, which this kernel
// equals bit for bit; the checkerboard expand, the fix's suspects and
// scatter and the edge AA around it stay plain PyTorch.
//
// What bounds it on the H100: the plain version is one ATen kernel per
// expression, every intermediate a plane in device memory (~1150 kernels
// and ~6 GB a 1920x1088 checkerboard lattice). What the work needs is ~20
// bytes a sample (depth, id, the colour written), the winner's record
// once per distinct triangle (at most 131072 x 45 x 4 bytes, inside the 50
// MB L2) and texel and shadow-map words mostly from L1/L2: latency of
// dependent gathers (id -> record -> texels, world -> shadow texels), not
// bandwidth or FP32 arithmetic.
//
// Design: one launch per call. A CTA of 256 threads owns a 32x8 tile of a
// lattice (or 256 entries of a pixel list), so a warp's samples share
// triangles, texels and shadow texels in L1. A thread reads its sample's
// depth and id where they lie in the visibility buffer (the lattice's
// packing is index arithmetic), then the 52 leading columns of the
// winner's 64-column record as 13 float4 loads, issued together; every
// intermediate stays in registers and the colour is written once. The
// options (given barycentrics, textures, normal maps, trilinear) are flags
// read once, uniform across the launch; the per-light casts (shadow slot,
// point or directional, traced plane), static on the host, ride in the
// kernel's parameters. Light table, matrices and atlases are read on the
// device, so a call reads nothing back to the host.
//
// Exactness against the plain version (bit for bit, as PyTorch's CUDA
// kernels round): every product and sum in the plain version's order
// ((x0 + x1) + x2 for a dot); IEEE division and square root; a tensor
// divided by a Python number is a product with the number's float
// reciprocal (ATen's div_true with a CPU scalar: 1 / b in double, rounded
// to float), `1.0 / t` a reciprocal;
// `** 5` and `** 2.4` are powf, `** 2` and `torch.square` a product;
// clamps propagate NaN as ATen's do; Python float constants round to
// double, then to float (PYF); no FMA contraction (built with -fmad=false).
// A dead light's arithmetic is skipped: its term adds 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32, TY = 8;  // a CTA's tile of lattice samples
constexpr int THREADS = TX * TY;
constexpr int MAX_LIGHTS = 64;  // light-table slots a call may shade (ops/pbr.py MAX_LIGHTS)
constexpr int NO_TRIANGLE = -1;
constexpr int SR_COLS = 64;  // ops/geometry.py's record layout
constexpr int REC_LOADS = 13;  // float4 loads of a record: columns 0..51 hold all 45 read
constexpr int SR_UV = 9, SR_TANGENT = 15, SR_TEXLOD = 27, SR_BASE = 29, SR_METALLIC = 33,
              SR_ROUGH = 34, SR_EMISSIVE = 35, SR_BC_LAYER = 38, SR_NM_LAYER = 39, SR_EDGE = 40;
constexpr int F_BARY = 1, F_TEXTURES = 2, F_NORMAL_MAPS = 4, F_TRILINEAR = 8;

// A Python float constant as PyTorch takes it: rounded to double, then to float.
#define PYF(x) static_cast<float>(x)
constexpr float NM_LOD_BIAS = PYF(1.5);
constexpr float PI_F = PYF(3.141592653589793);

struct Params {
  const float* depth;       // (vh, vw) the visibility buffer
  const int* tri;           // (vh, vw)
  const float* bary;        // (3, vh, vw) or null: from the records' edge columns
  const float* rec;         // (T, SR_COLS), 16-byte aligned
  const int* texels;        // the texture atlas's packed RGBA words
  const int* level_size;    // (n_levels,)
  const int* level_offset;  // (n_levels,)
  const float* cam;         // (3,)
  const float* vp_inv;      // (4, 4) at strides vp_sr, vp_sc
  const float* lpos;        // (L, 3)
  const float* lcol;        // (L, 3)
  const float* lint;        // (L,)
  const bool* ldir;         // (L,)
  const bool* lalive;       // (L,)
  const float* bg;          // (3,)
  const long long* xk;      // (n,) a pixel list's x, or null: a lattice
  const long long* yk;      // (n,)
  const bool* good;         // (n,) false: shaded as uncovered
  const float* shadow;      // (slots, S, S) or null
  const float* light_mats;  // (L, 6, 4, 4)
  const float* planes;      // (planes, n) traced occlusion, or null
  float* out;               // (3, n)
  int vp_sr, vp_sc, vh, vw, n, gh, gw, step_x, step_y, checker, y0, width, full_height, n_levels,
      shadow_size, flags, n_lights;
  float ambient;
  // the reciprocals a tensor divided by a Python number is multiplied with,
  // as ATen's div_true takes them: 1 / b in double, rounded to float (1.0f /
  // 1.055f is one unit off that), divided on the host at run time
  float inv_width, inv_full_height, inv_face_h, inv_12_92, inv_1_055, inv_pi;
};

// per shaded light: its shadow slot (-1 none), point light or not, its traced plane (-1 none)
struct Casts {
  int slot[MAX_LIGHTS];
  int point[MAX_LIGHTS];
  int plane[MAX_LIGHTS];
};

// ATen's clamps: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// _normalize_cf
__device__ __forceinline__ void normalize3(float (&v)[3]) {
  const float d = clamp_min(sqrt_(dot3(v, v)), PYF(1e-8));
  for (int k = 0; k < 3; ++k) v[k] = div_(v[k], d);
}

struct Atlas {
  const int* texels;
  long long s0, n_slots;
  int n_levels;
};

// texture.py _bilinear: channels 0..2 of level `level`, layer `layer` (>= 0)
__device__ void bilinear(const Atlas& a, long long level, long long layer, float u, float v,
                         float (&out)[3]) {
  const long long size = a.s0 >> level;
  const long long off = a.n_levels == 1 ? 0 : a.n_slots * (((a.s0 * a.s0 - size * size) * 4) / 3);
  const float fs = (float)size;
  const float tx = u * fs - 0.5f, ty = v * fs - 0.5f;
  const float x0f = floorf(tx), y0f = floorf(ty);
  const float fx = tx - x0f, fy = ty - y0f;
  const long long x0 = (long long)x0f, y0 = (long long)y0f, m = size - 1;
  const long long xa = x0 & m, xb = (x0 + 1) & m, ya = y0 & m, yb = (y0 + 1) & m;
  const int* base = a.texels + off;
  const int t00 = __ldg(base + (layer * size + ya) * size + xa);
  const int t10 = __ldg(base + (layer * size + ya) * size + xb);
  const int t01 = __ldg(base + (layer * size + yb) * size + xa);
  const int t11 = __ldg(base + (layer * size + yb) * size + xb);
  const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
  const float k255 = PYF(1.0 / 255.0);
  for (int c = 0; c < 3; ++c) {
    const int sh = 8 * c;
    out[c] = (float)((t00 >> sh) & 0xFF) * k255 * w00 + (float)((t10 >> sh) & 0xFF) * k255 * w10 +
             (float)((t01 >> sh) & 0xFF) * k255 * w01 + (float)((t11 >> sh) & 0xFF) * k255 * w11;
  }
}

// texture.py sample_atlas_cf with a lod: channels 0..2; layer < 0 is white
__device__ void sample_atlas(const Atlas& a, int layer, float u, float v, float lod, bool trilinear,
                             float (&out)[3]) {
  if (layer < 0) {
    out[0] = out[1] = out[2] = 1.0f;
    return;
  }
  const float uf = u - floorf(u), vf = v - floorf(v);
  lod = clamp2(lod, 0.0f, (float)(a.n_levels - 1));
  const long long l0 = (long long)floorf(lod);
  bilinear(a, l0, layer, uf, vf, out);
  if (trilinear) {
    const long long l1 = min(l0 + 1, (long long)(a.n_levels - 1));
    const float f = lod - (float)l0;
    float o1[3];
    bilinear(a, l1, layer, uf, vf, o1);
    for (int c = 0; c < 3; ++c) out[c] = out[c] * (1.0f - f) + o1[c] * f;
  }
}

__device__ __forceinline__ float srgb_to_linear(const Params& p, float c) {
  return c <= PYF(0.04045) ? c * p.inv_12_92 : powf((c + PYF(0.055)) * p.inv_1_055, PYF(2.4));
}

// shadow.py _project: points under a 4x4 matrix given row by row
__device__ __forceinline__ bool project(const float* m, const float (&w2)[3], float& u, float& v,
                                        float& d) {
  float clip[4];
  for (int i = 0; i < 4; ++i) {
    clip[i] = __ldg(m + 4 * i) * w2[0] + __ldg(m + 4 * i + 1) * w2[1] +
              __ldg(m + 4 * i + 2) * w2[2] + __ldg(m + 4 * i + 3);
  }
  const float w = fabsf(clip[3]) > PYF(1e-9) ? clip[3] : PYF(1e-9);
  u = (div_(clip[0], w) + 1.0f) * 0.5f;
  v = (1.0f - div_(clip[1], w)) * 0.5f;
  d = div_(clip[2], w);
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f && d >= 0.0f && d <= 1.0f;
}

// shadow.py _pcf inside the texel rectangle [x_lo, x_hi] x [y_lo, y_hi]
__device__ float pcf(const float* slot, int s, float tx, float ty, float ref, long long x_lo,
                     long long x_hi, long long y_lo, long long y_hi) {
  const float x0f = floorf(tx), y0f = floorf(ty);
  const float fx = tx - x0f, fy = ty - y0f;
  const long long x0 = (long long)x0f, y0 = (long long)y0f;
  const long long xc = min(max(x0, x_lo), x_hi), yc = min(max(y0, y_lo), y_hi);
  const long long x1 = x0 >= x_lo ? min(xc + 1, x_hi) : xc;
  const long long y1 = y0 >= y_lo ? min(yc + 1, y_hi) : yc;
  const float l00 = ref <= __ldg(slot + yc * s + xc) ? 1.0f : 0.0f;
  const float l01 = ref <= __ldg(slot + yc * s + x1) ? 1.0f : 0.0f;
  const float l10 = ref <= __ldg(slot + y1 * s + xc) ? 1.0f : 0.0f;
  const float l11 = ref <= __ldg(slot + y1 * s + x1) ? 1.0f : 0.0f;
  return l00 * (1.0f - fx) * (1.0f - fy) + l01 * fx * (1.0f - fy) + l10 * (1.0f - fx) * fy +
         l11 * fx * fy;
}

// shadow.py shadow_occlusion with the geometric normal: 1 lit, 0 shadowed
__device__ float shadow_occlusion(const Params& p, int li, int slot, bool point,
                                  const float (&world)[3], const float (&ng)[3], float ndl) {
  const int s = p.shadow_size;
  const float* depth = p.shadow + (long long)slot * s * s;
  const float* mats = p.light_mats + li * 96;
  const float slope = div_(sqrt_(clamp_min(1.0f - ndl * ndl, 0.0f)), clamp_min(ndl, PYF(1e-2)));
  const float bias_term = clamp_max(slope, PYF(4.0)) * PYF(3e-3) + PYF(1e-3);
  float w2[3], u, v, d;
  if (!point) {
    const float m0 = __ldg(mats), m1 = __ldg(mats + 1), m2 = __ldg(mats + 2);
    const float row_norm = sqrt_(m0 * m0 + m1 * m1 + m2 * m2) + PYF(1e-12);
    const float off = rcp(row_norm * (float)s) * 2.0f * PYF(1.5);
    for (int k = 0; k < 3; ++k) w2[k] = world[k] + ng[k] * off;
    if (!project(mats, w2, u, v, d)) return 1.0f;
    return pcf(depth, s, u * (float)s - 0.5f, v * (float)s - 0.5f, d - bias_term, 0, s - 1, 0,
               s - 1);
  }
  const int fw = s / 2, fh = s / 4;
  const float lp[3] = {__ldg(p.lpos + 3 * li), __ldg(p.lpos + 3 * li + 1),
                       __ldg(p.lpos + 3 * li + 2)};
  const float dv[3] = {world[0] - lp[0], world[1] - lp[1], world[2] - lp[2]};
  const float dist = sqrt_(dot3(dv, dv));
  const float off = dist * 2.0f * p.inv_face_h * PYF(1.5);
  for (int k = 0; k < 3; ++k) w2[k] = world[k] + ng[k] * off;
  const float dl[3] = {w2[0] - lp[0], w2[1] - lp[1], w2[2] - lp[2]};
  const float ax = fabsf(dl[0]), ay = fabsf(dl[1]), az = fabsf(dl[2]);
  const int face = (ax >= ay && ax >= az) ? (dl[0] >= 0.0f ? 0 : 1)
                   : ay >= az             ? (dl[1] >= 0.0f ? 2 : 3)
                                          : (dl[2] >= 0.0f ? 4 : 5);
  if (!project(mats + 16 * face, w2, u, v, d)) return 1.0f;
  const long long x_lo = (long long)(face % 2) * fw, y_lo = (long long)(face / 2) * fh;
  return pcf(depth, s, (float)x_lo + u * (float)fw - 0.5f, (float)y_lo + v * (float)fh - 0.5f,
             d - bias_term, x_lo, x_lo + fw - 1, y_lo, y_lo + fh - 1);
}

// pbr.py _ggx_brdf for one sample: (diffuse + specular) * n.l per channel
__device__ void ggx_brdf(const float (&n)[3], const float (&v)[3], const float (&l)[3],
                         const float (&albedo)[3], float metallic, float roughness, float inv_pi,
                         float (&out)[3]) {
  float h[3] = {v[0] + l[0], v[1] + l[1], v[2] + l[2]};
  normalize3(h);
  const float ndl = clamp_min(dot3(n, l), 0.0f);
  const float ndv = clamp_min(dot3(n, v), PYF(1e-4));
  const float ndh = clamp_min(dot3(n, h), 0.0f);
  const float vdh = clamp_min(dot3(v, h), 0.0f);
  const float a = clamp_min(roughness * roughness, PYF(1e-3));
  const float a2 = a * a;
  const float denom = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = div_(a2, clamp_min(denom * PI_F * denom, PYF(1e-9)));
  const float gv = ndl * sqrt_(ndv * ndv * (1.0f - a2) + a2);
  const float gl = ndv * sqrt_(ndl * ndl * (1.0f - a2) + a2);
  const float vis = rcp(clamp_min(gv + gl, PYF(1e-9))) * 0.5f;
  const float p5 = powf(1.0f - vdh, PYF(5.0));
  const float one_m = 1.0f - metallic;
  for (int c = 0; c < 3; ++c) {
    const float f0 = one_m * PYF(0.04) + albedo[c] * metallic;
    const float f = f0 + (1.0f - f0) * p5;
    const float specular = d * vis * f;
    const float diffuse = albedo[c] * one_m * (1.0f - f) * inv_pi;
    out[c] = (diffuse + specular) * ndl;
  }
}

// One covered sample: its depth, triangle (>= 0), pixel centre and (given)
// barycentrics -> colour.
__device__ void shade_sample(const Params& p, const Casts& casts, int s, int id, float depth,
                             float px, float py, const float* bary_at, float (&color)[3]) {
  // the winner's record, columns 0..51
  float r[4 * REC_LOADS];
  const float4* r4 = reinterpret_cast<const float4*>(p.rec + (long long)id * SR_COLS);
#pragma unroll
  for (int q = 0; q < REC_LOADS; ++q) {
    const float4 t = __ldg(r4 + q);
    r[4 * q] = t.x, r[4 * q + 1] = t.y, r[4 * q + 2] = t.z, r[4 * q + 3] = t.w;
  }

  // geometry.unproject_depth
  const float xn = px * p.inv_width * 2.0f - 1.0f;
  const float yn = 1.0f - py * p.inv_full_height * 2.0f;
  float plane[4];
  for (int i = 0; i < 4; ++i) {
    const float* m = p.vp_inv + i * p.vp_sr;
    plane[i] = __ldg(m) * xn + __ldg(m + p.vp_sc) * yn + __ldg(m + 2 * p.vp_sc) * depth +
               __ldg(m + 3 * p.vp_sc);
  }
  const float inv_w = rcp(fabsf(plane[3]) > PYF(1e-12) ? plane[3] : PYF(1e-12));
  const float world[3] = {plane[0] * inv_w, plane[1] * inv_w, plane[2] * inv_w};

  float b0, b1, b2;
  if (bary_at != nullptr) {
    const long long pl = (long long)p.vh * p.vw;
    b0 = __ldg(bary_at), b1 = __ldg(bary_at + pl), b2 = __ldg(bary_at + 2 * pl);
  } else {  // the winner's edge functions at the pixel centre
    const float* e = r + SR_EDGE;
    const float lam0 = e[0] * px + e[1] * py + e[2];
    const float lam1 = e[3] * px + e[4] * py + e[5];
    const float lam2 = e[6] * px + e[7] * py + e[8];
    const float lsum = lam0 + lam1 + lam2;
    const float inv = rcp(lsum != 0.0f ? lsum : 1.0f);
    b0 = lam0 * inv, b1 = lam1 * inv, b2 = lam2 * inv;
  }
  // the 8 attributes of each corner: normal xyz, uv, tangent xyz
  float attr[8];
  for (int k = 0; k < 8; ++k) {
    const int c0 = k < 3 ? k : k < 5 ? SR_UV + (k - 3) : SR_TANGENT + (k - 5);
    const int step = k < 3 ? 3 : k < 5 ? 2 : 4;
    attr[k] = b0 * r[c0] + b1 * r[c0 + step] + b2 * r[c0 + 2 * step];
  }
  float ng[3] = {attr[0], attr[1], attr[2]};
  normalize3(ng);
  const float u = attr[3], v_ = attr[4];
  const float tex_lod = r[SR_TEXLOD], metallic = r[SR_METALLIC];
  float roughness = r[SR_ROUGH];
  const int bc_layer = (int)r[SR_BC_LAYER], nm_layer = (int)r[SR_NM_LAYER];
  const Atlas atlas{p.texels, __ldg(p.level_size),
                    p.n_levels == 1 ? 0
                                    : (long long)__ldg(p.level_offset + 1) /
                                          ((long long)__ldg(p.level_size) * __ldg(p.level_size)),
                    p.n_levels};
  const bool trilinear = p.flags & F_TRILINEAR;

  float albedo[3] = {r[SR_BASE], r[SR_BASE + 1], r[SR_BASE + 2]};
  if (p.flags & F_TEXTURES) {
    float bc[3];
    sample_atlas(atlas, bc_layer, u, v_, tex_lod, trilinear, bc);
    for (int c = 0; c < 3; ++c) albedo[c] = albedo[c] * srgb_to_linear(p, bc[c]);
  }

  float n[3] = {ng[0], ng[1], ng[2]};
  if ((p.flags & F_TEXTURES) && (p.flags & F_NORMAL_MAPS) && nm_layer >= 0) {
    const float tangent[3] = {attr[5], attr[6], attr[7]};
    const float tn = dot3(tangent, ng);
    float t[3] = {tangent[0] - ng[0] * tn, tangent[1] - ng[1] * tn, tangent[2] - ng[2] * tn};
    normalize3(t);
    const float tan_w = r[SR_TANGENT + 3];
    const float b[3] = {(ng[1] * t[2] - ng[2] * t[1]) * tan_w,
                        (ng[2] * t[0] - ng[0] * t[2]) * tan_w,
                        (ng[0] * t[1] - ng[1] * t[0]) * tan_w};
    float nm[3];
    sample_atlas(atlas, nm_layer, u, v_, tex_lod + NM_LOD_BIAS, trilinear, nm);
    const float nx = nm[0] * 2.0f - 1.0f, ny = nm[1] * 2.0f - 1.0f, nz = nm[2] * 2.0f - 1.0f;
    for (int k = 0; k < 3; ++k) n[k] = t[k] * nx + b[k] * ny + ng[k] * nz;
    normalize3(n);
    // Toksvig
    const float len2 = clamp_min(nx * nx + ny * ny + nz * nz, PYF(1e-6));
    const float ell = sqrt_(len2);
    const float sigma2 = clamp2(div_(1.0f - ell, ell), 0.0f, 1.0f);
    const float r2 = roughness * roughness;
    const float alpha2 = r2 * r2 + sigma2;
    roughness = sqrt_(sqrt_(clamp_max(alpha2, 1.0f)));
  }

  float view[3] = {__ldg(p.cam) - world[0], __ldg(p.cam + 1) - world[1],
                   __ldg(p.cam + 2) - world[2]};
  normalize3(view);
  for (int c = 0; c < 3; ++c) color[c] = albedo[c] * p.ambient + r[SR_EMISSIVE + c];
  for (int li = 0; li < p.n_lights; ++li) {
    if (!p.lalive[li]) {  // + where(alive, contrib, 0.0)
      for (int c = 0; c < 3; ++c) color[c] = color[c] + 0.0f;
      continue;
    }
    const bool directional = p.ldir[li];
    const float pos[3] = {__ldg(p.lpos + 3 * li), __ldg(p.lpos + 3 * li + 1),
                          __ldg(p.lpos + 3 * li + 2)};
    float l[3];
    for (int k = 0; k < 3; ++k) l[k] = directional ? -pos[k] : pos[k] - world[k];
    const float dist2 = dot3(l, l);
    const float len = sqrt_(clamp_min(dist2, PYF(1e-12)));
    for (int k = 0; k < 3; ++k) l[k] = div_(l[k], len);
    const float atten = directional ? 1.0f : rcp(clamp_min(dist2, PYF(1e-4)));
    const float ia = __ldg(p.lint + li) * atten;
    float radiance[3];
    for (int c = 0; c < 3; ++c) radiance[c] = __ldg(p.lcol + 3 * li + c) * ia;
    if (casts.plane[li] >= 0) {
      const float lit = __ldg(p.planes + (long long)casts.plane[li] * p.n + s);
      for (int c = 0; c < 3; ++c) radiance[c] = radiance[c] * lit;
    }
    if (casts.slot[li] >= 0) {
      const float ndl_geom = clamp_min(dot3(ng, l), 0.0f);
      const float occ =
          shadow_occlusion(p, li, casts.slot[li], casts.point[li] != 0, world, ng, ndl_geom);
      for (int c = 0; c < 3; ++c) radiance[c] = radiance[c] * occ;
    }
    float brdf[3];
    ggx_brdf(n, view, l, albedo, metallic, roughness, p.inv_pi, brdf);
    for (int c = 0; c < 3; ++c) color[c] = color[c] + brdf[c] * radiance[c];
  }
}

__global__ void __launch_bounds__(THREADS) shade_kernel(const Params p, const Casts casts) {
  int s, x, y;
  bool good = true;
  if (p.xk != nullptr) {  // a pixel list
    s = blockIdx.x * THREADS + threadIdx.y * TX + threadIdx.x;
    if (s >= p.n) return;
    x = (int)p.xk[s], y = (int)p.yk[s], good = p.good[s];
  } else {  // sample (i, j) of a lattice
    const int j = blockIdx.x * TX + threadIdx.x, i = blockIdx.y * TY + threadIdx.y;
    if (j >= p.gw || i >= p.gh) return;
    s = i * p.gw + j;
    y = p.step_y * i;
    x = p.step_x * j + (p.checker ? ((y + p.y0) & 1) : 0);
  }
  const long long pix = (long long)y * p.vw + x;
  const int tri = good ? __ldg(p.tri + pix) : NO_TRIANGLE;
  float color[3];
  if (tri == NO_TRIANGLE) {
    color[0] = __ldg(p.bg), color[1] = __ldg(p.bg + 1), color[2] = __ldg(p.bg + 2);
  } else {
    shade_sample(p, casts, s, max(tri, 0), __ldg(p.depth + pix), (float)x + 0.5f,
                 (float)(y + p.y0) + 0.5f, (p.flags & F_BARY) ? p.bary + pix : nullptr, color);
  }
  for (int c = 0; c < 3; ++c) p.out[(long long)c * p.n + s] = color[c];
}

}  // namespace

extern "C" void rtt_shade_design(int* out) {
  const int v[4] = {TX, TY, THREADS, MAX_LIGHTS};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}

// Launches kernel 7 on `stream`; returns cudaGetLastError() (0 on success).
// `ptrs` (device pointers, 0 for none) and `ints` in ops/pbr.py
// shade_samples_kernel's order: depth, tri, bary, rec, texels, level_size,
// level_offset, cam, vp_inv, lpos, lcol, lint, ldir, lalive, bg, xk, yk,
// good, shadow, light_mats, planes, out; vp_inv's row and column strides,
// vh, vw, n, gh, gw, step_x, step_y, checker, y0, width, full_height,
// n_levels, shadow_size, flags, n_lights, then per shaded light its shadow
// slot, point flag and traced plane.
extern "C" int rtt_shade(const uint64_t* ptrs, const int* ints, float ambient, void* stream) {
  Params p;
  p.depth = (const float*)ptrs[0], p.tri = (const int*)ptrs[1], p.bary = (const float*)ptrs[2];
  p.rec = (const float*)ptrs[3], p.texels = (const int*)ptrs[4];
  p.level_size = (const int*)ptrs[5], p.level_offset = (const int*)ptrs[6];
  p.cam = (const float*)ptrs[7], p.vp_inv = (const float*)ptrs[8];
  p.lpos = (const float*)ptrs[9], p.lcol = (const float*)ptrs[10], p.lint = (const float*)ptrs[11];
  p.ldir = (const bool*)ptrs[12], p.lalive = (const bool*)ptrs[13], p.bg = (const float*)ptrs[14];
  p.xk = (const long long*)ptrs[15], p.yk = (const long long*)ptrs[16];
  p.good = (const bool*)ptrs[17], p.shadow = (const float*)ptrs[18];
  p.light_mats = (const float*)ptrs[19], p.planes = (const float*)ptrs[20];
  p.out = (float*)ptrs[21];
  p.vp_sr = ints[0], p.vp_sc = ints[1];
  ints += 2;
  p.vh = ints[0], p.vw = ints[1], p.n = ints[2], p.gh = ints[3], p.gw = ints[4];
  p.step_x = ints[5], p.step_y = ints[6], p.checker = ints[7], p.y0 = ints[8];
  p.width = ints[9], p.full_height = ints[10], p.n_levels = ints[11], p.shadow_size = ints[12];
  p.flags = ints[13], p.n_lights = ints[14];
  p.ambient = ambient;
  volatile double one = 1.0;  // no constant folding: the host's IEEE double division
  p.inv_width = (float)(one / p.width), p.inv_full_height = (float)(one / p.full_height);
  p.inv_face_h = (float)(one / (p.shadow_size / 4 > 0 ? p.shadow_size / 4 : 1));
  p.inv_12_92 = (float)(one / 12.92), p.inv_1_055 = (float)(one / 1.055);
  p.inv_pi = (float)(one / 3.141592653589793);
  if (p.n_lights < 0 || p.n_lights > MAX_LIGHTS || p.n < 0 || p.n_levels < 1 ||
      (uintptr_t)p.rec % 16 || (p.xk == nullptr && (long long)p.gh * p.gw != p.n)) {
    return (int)cudaErrorInvalidValue;
  }
  Casts casts;
  for (int li = 0; li < MAX_LIGHTS; ++li) {
    const bool on = li < p.n_lights;
    casts.slot[li] = on ? ints[15 + 3 * li] : -1;
    casts.point[li] = on ? ints[16 + 3 * li] : 0;
    casts.plane[li] = on ? ints[17 + 3 * li] : -1;
    if ((casts.slot[li] >= 0 && (p.shadow == nullptr || p.shadow_size < 4)) ||
        (casts.plane[li] >= 0 && p.planes == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (p.n == 0) return (int)cudaSuccess;
  const dim3 block(TX, TY);
  const dim3 grid = p.xk != nullptr ? dim3((p.n + THREADS - 1) / THREADS)
                                    : dim3((p.gw + TX - 1) / TX, (p.gh + TY - 1) / TY);
  shade_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p, casts);
  return (int)cudaGetLastError();
}
