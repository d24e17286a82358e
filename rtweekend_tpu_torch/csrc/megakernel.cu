// Bounce megakernel for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel rtweekend_tpu/ops/pallas/megakernel.py:_make_kernel, launched
// there by _trace_segment (pl.pallas_call at megakernel.py:1050). The
// same library holds raygen_kernel, a render batch's camera rays (see its
// note below the bounce kernel).
//
// What it computes: for every ray of the buffer, up to n_bounces path-
// tracing bounces starting at global bounce b0 — closest hit over all
// 2S+6R coefficient rows (min t, lowest index on ties), the winner's
// attributes, PCG4D draws at streams BOUNCE_STREAM0+2(b0+b) and +1,
// Lambertian / metal / dielectric scatter with the solid, checker, noise
// or image texture, and the sky / emission radiance update. It emits the
// segment's radiance delta [3, m] and the carried state [m, 14]. Rays
// dead at entry pass through untouched.
//
// Given an accumulation buffer `accum` [3, cols] instead, a finished ray
// adds its radiance into column ray_id (the state's S_RID) and no radiance
// delta is written: trace_paths_compact, the compacted trace, sums its
// segments there. A live ray id occurs in one row of a buffer and the
// segments of a batch run in order on one stream, so the add is a plain
// read-modify-write: the same float32 add, on the same operands in the same
// order, as a per-channel index_add_ of the radiance delta at the ray ids.
// Rows dead at entry, among them the compacted buffer's padding rows, which
// all repeat one ray id, touch no column: an index_add_ adds each padding
// row's zero at that one id, and those same-address atomics serialize
// (PERF.md).
//
// Variants, as template flags (the C entry point picks the instantiation):
// - HAS_MOTION: the moving-center lerp (final_scene);
// - WANT_WINNERS (megakernel.py:892, :902-903) also writes winners
//   [n_bounces, m] int32, the closest-hit primitive of every bounce
//   (spheres 0..S-1, then rects S..S+R-1), -1 on a miss and on every
//   bounce after the ray died — the path decisions the differentiable
//   replay (ops/replay.py) re-traces;
// - HAS_NOISE (megakernel.py:459-525, :676-696): 7-octave Perlin
//   turbulence, gray 0.5*(1 + sin(scale*z + 10*turb)), for a live hit on a
//   noise texture (two_perlin_spheres, simple_light);
// - HAS_IMAGE (megakernel.py:348-375, :698-786): sphere UV from the
//   Cephes atan2/acos polynomials or rect UV from the affine attribute
//   rows, the nearest texel of the packed RGBA atlas, alpha 0 -> (0,0,1),
//   for a live hit on an image texture (earth);
// - HAS_SKY (megakernel.py:428-431, :861-870, :1001): a miss adds the
//   lerp of two background colors by 0.5*(unit(d).y + 1) (golden_scene).
// The instantiations, each with and without winners: motion alone
// (final_scene), none (the flat-sky solid/checker scenes), image alone
// (earth), and a general one (motion, noise and image compiled in, with
// and without the sky) for every other scene: the moving-center lerp is
// exact on a static sphere (its center delta is 0) and the texture
// branches only run for their own texture type, so the general
// instantiation computes the same function, bit for bit as measured.
// On the H100 at the 600x400 scenes' segments a noise-only or sky-only
// instantiation was no faster than the general one, so neither is built;
// image alone was ~5% faster on earth (PERF.md).
//
// Design for Hopper: persistent blocks that refill finished rays, lane
// groups for small buffers. The function is the first version's (one
// thread per ray, the bounce loop inside the thread) bit for bit: each
// ray's arithmetic is unchanged, only where the work runs and in what
// order. What bounded the first version on this card, and what each part
// of the design does about it:
// - Dead lanes (a warp ran while any of its lanes lived: 72.5% of the
//   lane-bounces of the first render segment live, 5.6% at the train
//   step's full-depth 811,008-lane launch). Persistent threads that fetch
//   work dynamically (Aila & Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009): the grid is the occupancy
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the table's dynamic
//   shared memory, cached per instantiation) times the SM count. A lane
//   group holds one ray and that ray's own bounce counter b, so its RNG
//   streams and winners row are b0 + b. When the ray dies or reaches
//   n_bounces the group's leader writes its state row, its radiance and,
//   with winners, -1 over the rest of its column; the group then takes the
//   next ray index from a device counter (zeroed by the C entry with
//   cudaMemsetAsync on the launch stream) by a warp-aggregated atomicAdd:
//   ballot of the leaders that need a ray, popc, one atomic a warp. Rays
//   dead at entry are copied through when fetched.
// - Too few threads for the late segments (8,192 lanes are 32 blocks on
//   132 SMs, each thread one ray's 30 bounces over ~490 spheres, a chain
//   of dependent multiply-adds). Lane groups: G in {1, 2, 4, 8, 16, 32}
//   lanes share a ray, G chosen by the wrapper from the lane count, the
//   segment's bounces and the table size (megakernel.launch_shape). A
//   group's lanes are 32/G apart in the warp (group j is lanes j, j + 32/G,
//   ...), so the 8 lanes of a quarter-warp hold the same rank of different
//   groups and read the same coefficient row (G <= 4) or few rows: with
//   contiguous groups 4 and 8 lanes a ray ran up to 1.7x slower than 2
//   (PERF.md). Lane k of a group scans primitives k, k+G, ...
//   and the group reduces (t, index) by xor shuffles in lexicographic
//   order, smaller t first and the lower index on equal t: the winner of
//   a strict `t < best` scan in index order (megakernel.py:576-581 takes
//   the lowest index too). Shading runs in all G lanes with the same
//   values; the leader writes. Every __shfl_*_sync is reached by the whole
//   warp: the refill loop is structured at warp level, and exhausted
//   groups go round with the rest until every group of the warp is done.
// - One dependent chain per ray-bounce: a lane computes 4 spheres' (8 dot
//   chains) or 2 rects' (12) dots straight-line before it compares their t
//   in index order, so the scheduler has independent multiply-adds to
//   issue; each dot keeps its column order. The roots of the 4 spheres are
//   skipped when none of their discriminants is positive (all four t are
//   then BIG and cannot win): per 4 spheres the scan issues 136 FFMA and
//   40 shared loads against ~30 other instructions.
// - The table staged once per 256 rays (3,168 blocks at the first render
//   segment) into 2 resident blocks an SM: a persistent block stages the
//   coefficient rows once, by TMA bulk copies (cp.async.bulk, one 80-byte
//   row of the 512-byte-strided table per request, completing on an
//   mbarrier), as 5 float4 (17 used columns + 3 zero columns). A warp
//   reads G consecutive rows at a time, one per rank: a broadcast at G = 1,
//   and at the 80-byte stride 8 consecutive rows fall in distinct banks.
//   final_scene's 1024 rows take 80 KB, above the 48 KB default, hence
//   cudaFuncSetAttribute; with the ~115 registers a thread of the unrolled
//   scan, 2 blocks of 256 fit an SM either way (16 warps).
// Winner attributes, the Perlin tables (3 x 256 permutation entries and 3
// x 256 gradient components, 6 KB) and the texel atlas are read through
// __ldg: the TPU kernel's half-row lookups (_lut256) and chunk walk over
// the atlas only work around the TPU's 128-lane gather. A texel is fetched
// only for a live hit on an image texture: for any other ray the texel
// index is meaningless and may lie outside the atlas. With WANT_WINNERS
// false the winners writes compile away.
//
// Numerics: fp32 only, no tensor cores, no fast-math. The sphere c_coef
// row cancels |beta|^2 ~ 1e6 (r = 1000 ground) to ~1e3, so reduced
// precision flips closest hits; logf/log1pf/sinf/cosf/expf/sqrtf are the
// accurate versions, division and sqrt IEEE-rounded, rsqrt written as
// 1/sqrtf, and the cube root of the fuzz radius is expf(logf(max(u,
// 1e-30))/3) as in the TPU kernel (megakernel.py:665). The noise texture's
// sin argument reaches ~4,000 on simple_light's r = 1000 ground, where
// __sinf would be far off: accurate sinf. atan2/acos are the TPU kernel's
// Cephes polynomials, not atan2f (~1e-7 rad apart, enough to move a
// nearest texel at a boundary). PCG4D runs natively in uint32 and is
// bit-equal to rtweekend_tpu/utils/rng.py.
//
// Bound on this card: per live ray-bounce, (2S+6R)*17 fp32 multiply-adds
// for the coefficient dots (final_scene: 1024*17 = 17,408 FMA) plus a
// ~10-op epilogue per primitive and a few hundred shading ops, against
// 67 TFLOP/s fp32 outside the tensor cores; the state traffic (2 x 56
// bytes per ray per launch) is far below the memory bound; so is the
// winners output (4 bytes per ray-bounce: 162 MB for 811,008 rays at depth
// 50, ~0.05 ms at 3.35 TB/s; written a ray at a time, a column per ray,
// so their sectors merge in L2 rather than across a warp). Texture work,
// counted from the code below as arithmetic operations per live hit
// (chip_smoke.py adds it to the bound): noise 1,338 = 7 octaves x 186 (8
// corners x 20 [3 add + 3 and + 2 xor on the lattice indices, 3 sub for
// the offsets, 2 mul for the weight, 5 for the dot, 2 to accumulate] + 3
// floor + 3 sub + 12 for the smoothstep + 3 for 1 - s + 2 to weight the
// octave + 3 to double the point) + 1 abs + ~30 for sinf's range
// reduction and polynomial + 5 for the gray value; image 118 = 2 x ~30
// for the two Cephes atan2 (abs, compare, select, max, divide, the second
// reduction, a 4-term polynomial, 3 quadrant fix-ups) + 4 for acos's
// sqrt(1 - c^2) + 4 pole guard + 2 clamp + 16 for the two rect rows + 4
// for u, v + 5 clamp and flip + 6 for the texel index + 10 to unpack + 7
// select; sky 15 per live miss (3 for t, 4 for each of the three lerps).
// What is left between the design and that bound: the shared-memory loads
// (5 LDS.128 for 17 FMAs a row, one ray a lane), the tail of a launch (the
// last rays' bounces run alone), and the redundant shading of a lane group.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 17;
constexpr int ROW_F4 = 5;   // one coefficient row in shared memory: 5 float4
constexpr int ROW_BYTES = ROW_F4 * 16;
constexpr int BLOCK = 256;  // ops/cuda/megakernel.py's BLOCK
constexpr int MIN_BLOCKS = 2;  // two blocks an SM: at most 128 registers a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int SW = 14;      // state row width, see ops/cuda/megakernel.py
enum { S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_TM, S_PID, S_SID,
       S_TR, S_TG, S_TB, S_AL, S_RID };
// attribute rows (megakernel.py:158-175)
enum { AF_C0X, AF_C0Y, AF_C0Z, AF_DCX, AF_DCY, AF_DCZ, AF_T0, AF_IDT,
       AF_INVR, AF_NX, AF_NY, AF_NZ, AF_FUZZ, AF_IOR,
       AF_CR, AF_CG, AF_CB, AF_C2R, AF_C2G, AF_C2B };
enum { AF_TSCALE = 20, AF_UWX, AF_UWY, AF_UWZ, AF_UC,
       AF_VWX, AF_VWY, AF_VWZ, AF_VC };
enum { AI_MTYPE, AI_TTYPE, AI_IMGW, AI_IMGH, AI_IMGBASE };
constexpr int MAT_METAL = 1;
constexpr int MAT_DIELECTRIC = 2;
constexpr int MAT_LIGHT = 3;
constexpr int TEX_CHECKER = 1;
constexpr int TEX_NOISE = 2;
constexpr int TEX_IMAGE = 3;
// variant flags of the C entry point
constexpr int V_MOTION = 1, V_IMAGE = 4, V_SKY = 8;  // 2: noise
constexpr float BIG = 1e30f;
constexpr float NEAR_ZERO = 1e-8f;
constexpr uint32_t BOUNCE_STREAM0 = 0x10000u;

struct Params {
  const float* coef;     // [n_rows, coef_stride], first 20 columns read
  int coef_stride;
  int n_rows;            // 2*s_pad + 6*r_pad
  const float* attr_f;   // [29, attr_stride]
  const int* attr_i;     // [5, attr_stride]
  int attr_stride;
  int s_pad;
  int r_pad;
  int s_live;            // spheres scanned: up to the last active one
  int r_live;            // rects scanned: up to the last active one
  const int* perm;       // [8, 128]: px[0:256], py[256:512], pz[512:768]
  const float* grad;     // [8, 128]: gx[0:256], gy[256:512], gz[512:768]
  const int* images;     // packed RGBA texels, r | g<<8 | b<<16 | a<<24
  const float* state_in; // [m, SW]
  float* state_out;      // [m, SW]
  float* rad;            // [3, m]; null when accum is given
  float* accum;          // [3, accum_cols], added to at each live ray's id, or null
  int accum_cols;
  int* winners;          // [n_bounces, m] when WANT_WINNERS, else null
  int m;
  uint32_t seed;
  float bg_r, bg_g, bg_b;     // flat sky; the gradient sky's bottom
  float bg1_r, bg1_g, bg1_b;  // the gradient sky's top
  int b0;
  int n_bounces;
  float t_min;
  int group;             // lanes a ray: 1, 2, 4, 8, 16 or 32
  int* counter;          // next ray index, 0 at launch
};

__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w; y += z * x; z += x * y; w += y * z;
  x ^= x >> 16; y ^= y >> 16; z ^= z >> 16; w ^= w >> 16;
  x += y * w; y += z * x; z += x * y; w += y * z;
}

// top 24 bits -> [0, 1)
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(int)(bits >> 8) * 0x1p-24f;
}

// feature . coefficient row, 17 multiply-adds in column order
__device__ __forceinline__ float dot_row(const float4* row, const float* f) {
  const float4 a = row[0], b = row[1], c = row[2], d = row[3], e = row[4];
  float s = a.x * f[0];
  s = fmaf(a.y, f[1], s);  s = fmaf(a.z, f[2], s);  s = fmaf(a.w, f[3], s);
  s = fmaf(b.x, f[4], s);  s = fmaf(b.y, f[5], s);  s = fmaf(b.z, f[6], s);
  s = fmaf(b.w, f[7], s);  s = fmaf(c.x, f[8], s);  s = fmaf(c.y, f[9], s);
  s = fmaf(c.z, f[10], s); s = fmaf(c.w, f[11], s); s = fmaf(d.x, f[12], s);
  s = fmaf(d.y, f[13], s); s = fmaf(d.z, f[14], s); s = fmaf(d.w, f[15], s);
  s = fmaf(e.x, f[16], s);
  return s;
}

// Perlin noise at q (utils/perlin.noise, reference perlin.zig:47-78) in the
// TPU kernel's operation order (megakernel.py:482-516): Hermite-smoothed
// trilinear interpolation of gradient dots over the 8 lattice corners.
// floor, then int, then & 255: two's complement wraps negative lattice
// coordinates as the TPU kernel does. The corner weight selects s or
// 1 - s (di*s + (1-di)*(1-s) in the TPU kernel, the same value).
__device__ __forceinline__ float perlin_noise(const int* __restrict__ perm,
                                              const float* __restrict__ grad,
                                              float qx, float qy, float qz) {
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  const float ux = qx - fx, uy = qy - fy, uz = qz - fz;
  const int ix0 = (int)fx, iy0 = (int)fy, iz0 = (int)fz;
  const float sx = ux * ux * (3.0f - 2.0f * ux);
  const float sy = uy * uy * (3.0f - 2.0f * uy);
  const float sz = uz * uz * (3.0f - 2.0f * uz);
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int ix = (ix0 + di) & 255;
        const int iy = (iy0 + dj) & 255;
        const int iz = (iz0 + dk) & 255;
        const int gi = __ldg(perm + ix) ^ __ldg(perm + 256 + iy) ^ __ldg(perm + 512 + iz);
        const float cx = __ldg(grad + gi);
        const float cy = __ldg(grad + 256 + gi);
        const float cz = __ldg(grad + 512 + gi);
        const float wx = ux - (float)di;
        const float wy = uy - (float)dj;
        const float wz = uz - (float)dk;
        const float w = (di ? sx : 1.0f - sx) * (dj ? sy : 1.0f - sy)
                      * (dk ? sz : 1.0f - sz);
        accum = accum + w * (cx * wx + cy * wy + cz * wz);
      }
    }
  }
  return accum;
}

// 7-octave turbulence |sum_k 2^-k noise(2^k q)| (perlin.zig:80-91,
// megakernel.py:518-525).
__device__ __noinline__ float perlin_turb(const int* __restrict__ perm,
                                          const float* __restrict__ grad,
                                          float qx, float qy, float qz) {
  float accum = 0.0f;
  float weight = 1.0f;
#pragma unroll 1
  for (int k = 0; k < 7; ++k) {
    accum = accum + weight * perlin_noise(perm, grad, qx, qy, qz);
    weight *= 0.5f;
    qx = qx * 2.0f; qy = qy * 2.0f; qz = qz * 2.0f;
  }
  return fabsf(accum);
}

// atan2 as the TPU kernel computes it (megakernel.py:348-370): octant
// reduction to t in [0, 1], a second reduction above tan(pi/8), and the
// Cephes atanf polynomial. Constants are the TPU kernel's double literals
// rounded to float.
__device__ __forceinline__ float atan2_cephes(float y, float x) {
  const float pi = (float)3.141592653589793;
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = fmaxf(swap ? ay : ax, (float)1e-30);
  float t = num / den;
  const bool med = t > (float)0.4142135623730950;
  t = med ? (t - 1.0f) / (t + 1.0f) : t;
  const float z = t * t;
  float q = (((float)8.05374449538e-2 * z - (float)1.38776856032e-1) * z
             + (float)1.99777106478e-1) * z - (float)3.33329491539e-1;
  q = q * z * t + t;
  q = med ? (float)(0.25 * 3.141592653589793) + q : q;
  q = swap ? (float)(0.5 * 3.141592653589793) - q : q;
  q = x < 0.0f ? pi - q : q;
  return y < 0.0f ? -q : q;
}

// acos(c) = atan2(sqrt(1 - c^2), c); the caller clamps |c| < 1
// (megakernel.py:372-375). 1 - c^2 as one fused multiply-add: near the
// poles it cancels, and the plain version rounds it once too.
__device__ __forceinline__ float acos_cephes(float c) {
  return atan2_cephes(sqrtf(fmaxf(fmaf(-c, c, 1.0f), 0.0f)), c);
}

// The image texture's color at a live hit (megakernel.py:700-779):
// sphere UV from the pre-flip outward normal with the pole guard, rect
// UV from the folded affine rows; the nearest texel (texture.zig:120-137
// with the j clamp), alpha 0 -> ocean blue (texture.zig:138-140).
__device__ __noinline__ float3 image_rgb(const float* __restrict__ af,
                                         const int* __restrict__ ai, size_t ast,
                                         size_t j, bool is_s,
                                         const int* __restrict__ images,
                                         float onx, float ony, float onz,
                                         float px, float py, float pz) {
  const float pi = (float)3.141592653589793;
  const bool at_pole = (fabsf(onz) + fabsf(onx)) < (float)1e-12;
  const float phi = atan2_cephes(-(at_pole ? 0.0f : onz), at_pole ? 1.0f : onx) + pi;
  const float theta = acos_cephes(
      fminf(fmaxf(-ony, (float)(-1.0 + 1e-7)), (float)(1.0 - 1e-7)));
  const float u_rect = px * __ldg(af + AF_UWX * ast + j) + py * __ldg(af + AF_UWY * ast + j)
                     + pz * __ldg(af + AF_UWZ * ast + j) + __ldg(af + AF_UC * ast + j);
  const float v_rect = px * __ldg(af + AF_VWX * ast + j) + py * __ldg(af + AF_VWY * ast + j)
                     + pz * __ldg(af + AF_VWZ * ast + j) + __ldg(af + AF_VC * ast + j);
  const float uu = is_s ? phi * (float)(0.5 / 3.141592653589793) : u_rect;
  const float vv = is_s ? theta * (float)(1.0 / 3.141592653589793) : v_rect;
  const int iw = __ldg(ai + AI_IMGW * ast + j);
  const int ih = __ldg(ai + AI_IMGH * ast + j);
  const int ibase = __ldg(ai + AI_IMGBASE * ast + j);
  const float uc = fminf(fmaxf(uu, 0.0f), 1.0f);
  const float vc = 1.0f - fminf(fmaxf(vv, 0.0f), 1.0f);
  const int ti = min((int)(uc * (float)iw), iw - 1);
  const int tj = min((int)(vc * (float)ih), ih - 1);
  const int packed = __ldg(images + ((size_t)ibase + (size_t)tj * iw + ti));
  const float inv = (float)(1.0 / 255.0);
  if (((packed >> 24) & 255) == 0) return make_float3(0.0f, 0.0f, 1.0f);
  return make_float3((float)(packed & 255) * inv, (float)((packed >> 8) & 255) * inv,
                     (float)((packed >> 16) & 255) * inv);
}

// A sphere's discriminant and hit distance from its two coefficient dots
// (coeffs.quadratic_t); t is BIG unless disc > 0.
__device__ __forceinline__ float sphere_disc(float hb, float cc, float a) {
  return hb * hb - a * cc;
}

__device__ __forceinline__ float sphere_t(float hb, float disc, float inv_a, float t_min) {
  float t = BIG;
  if (disc > 0.f) {
    const float sq = sqrtf(disc);
    const float root1 = -(hb + sq) * inv_a;
    const float root2 = (sq - hb) * inv_a;
    const float t12 = root1 >= t_min ? root1 : root2;
    if (t12 >= t_min) t = t12;
  }
  return t;
}

// A rect's hit distance from its six coefficient dots (coeffs.rect_t). The
// u and v dots are computed whether or not dn is 0: t is BIG then either way.
__device__ __forceinline__ float rect_t(float kn, float dn, float ua, float da,
                                        float vb, float db, float t_min) {
  float t = BIG;
  if (dn != 0.f) {
    const float tt = kn / dn;
    const float u = ua + tt * da;
    const float v = vb + tt * db;
    if (tt >= t_min && u >= 0.f && u <= 1.f && v >= 0.f && v <= 1.f) t = tt;
  }
  return t;
}

// This lane's share of the closest-hit scan: primitives k, k+G, ... in index
// order, strict `t < best`, so (best, idx) is the lexicographic minimum of
// (t, index) over the share (idx stays INT_MAX while nothing is below BIG).
// 4 spheres (8 dot chains) or 2 rects (12) are computed before their t are
// compared. Only the first s_live spheres and r_live rects are scanned: the
// rows of the inactive primitives after them are zero (t = BIG, never a
// winner). S and R are the padded counts that lay the rows out.
__device__ __forceinline__ void scan_share(const float4* __restrict__ rows, int S, int R,
                                           int s_live, int r_live, int k, int G,
                                           const float* f, float a, float inv_a, float t_min,
                                           float& best, int& idx) {
  int s = k;
  for (; s + 3 * G < s_live; s += 4 * G) {
    float hb[4], disc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      hb[u] = dot_row(rows + (s + u * G) * ROW_F4, f);
      disc[u] = sphere_disc(hb[u], dot_row(rows + (S + s + u * G) * ROW_F4, f), a);
    }
    // most spheres miss most rays: with no positive discriminant all four
    // t are BIG and none can win, so their roots are skipped
    if (fmaxf(fmaxf(disc[0], disc[1]), fmaxf(disc[2], disc[3])) > 0.f) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float t = sphere_t(hb[u], disc[u], inv_a, t_min);
        if (t < best) { best = t; idx = s + u * G; }
      }
    }
  }
  for (; s < s_live; s += G) {
    const float hb = dot_row(rows + s * ROW_F4, f);
    const float t = sphere_t(hb, sphere_disc(hb, dot_row(rows + (S + s) * ROW_F4, f), a),
                             inv_a, t_min);
    if (t < best) { best = t; idx = s; }
  }
  const float4* rr = rows + 2 * S * ROW_F4;
  int r = k;
  for (; r + G < r_live; r += 2 * G) {
    float d[2][6];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int q = 0; q < 6; ++q) d[u][q] = dot_row(rr + (q * R + r + u * G) * ROW_F4, f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float t = rect_t(d[u][0], d[u][1], d[u][2], d[u][3], d[u][4], d[u][5], t_min);
      if (t < best) { best = t; idx = S + r + u * G; }
    }
  }
  for (; r < r_live; r += G) {
    float d[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) d[q] = dot_row(rr + (q * R + r) * ROW_F4, f);
    const float t = rect_t(d[0], d[1], d[2], d[3], d[4], d[5], t_min);
    if (t < best) { best = t; idx = S + r; }
  }
}

// Stage the coefficient rows into shared memory once per block: one TMA bulk
// copy (cp.async.bulk) of 80 bytes per row, all completing on one mbarrier
// whose transaction count thread 0 sets before any copy is issued.
__device__ __forceinline__ void stage_rows(const Params& p, float4* s_coef,
                                           unsigned long long* bar) {
  const uint32_t bar_a = (uint32_t)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar_a), "r"((uint32_t)(p.n_rows * ROW_BYTES)) : "memory");
  }
  __syncthreads();
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(s_coef);
  for (int r = threadIdx.x; r < p.n_rows; r += blockDim.x) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(dst + (uint32_t)(r * ROW_BYTES)), "l"(p.coef + (size_t)r * p.coef_stride),
           "r"(ROW_BYTES), "r"(bar_a) : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred q;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
        "selp.u32 %0, 1, 0, q;\n"
        "}\n"
        : "=r"(done) : "r"(bar_a) : "memory");
  }
}

template <bool HAS_MOTION, bool WANT_WINNERS, bool HAS_NOISE, bool HAS_IMAGE,
          bool HAS_SKY>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) bounce_kernel(const Params p) {
  extern __shared__ float4 s_coef[];
  __shared__ __align__(8) unsigned long long s_bar;
  stage_rows(p, s_coef, &s_bar);

  const int lane = threadIdx.x & 31;
  const int G = p.group;
  const int stride = 32 / G;       // groups in a warp; a group's lanes are stride apart
  const int k = lane / stride;     // this lane's rank in its group
  const int leader = lane - k * stride;
  const bool lead = k == 0;
  const size_t m = (size_t)p.m;
  const int S = p.s_pad;
  const int R = p.r_pad;
  const float t_min = p.t_min;
  const float* af = p.attr_f;
  const int* ai = p.attr_i;
  const size_t ast = (size_t)p.attr_stride;

  // the group's ray (i < 0: none) and its carried state
  int i = -1;
  bool exhausted = false;
  int b = 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tr = 0.f, tg = 0.f, tb = 0.f, time = 0.f;
  float rr = 0.f, rg = 0.f, rb = 0.f;
  uint32_t pix = 0, smp = 0;

  for (;;) {
    // ---- refill: every group without a ray takes the next live one ----
    for (;;) {
      const bool need = i < 0 && !exhausted;
      const unsigned want = __ballot_sync(FULL, need && lead);
      if (want == 0) break;
      const int first = __ffs(want) - 1;
      int base = 0;
      if (lane == first) base = atomicAdd(p.counter, __popc(want));
      base = __shfl_sync(FULL, base, first);
      if (need) {
        const int ray = base + __popc(want & ((1u << leader) - 1u));
        if (ray >= p.m) {
          exhausted = true;
        } else {
          const float* in = p.state_in + (size_t)ray * SW;
          const float al_in = in[S_AL];
          if (al_in > 0.5f && p.n_bounces > 0) {
            i = ray;
            b = 0;
            ox = in[S_OX]; oy = in[S_OY]; oz = in[S_OZ];
            dx = in[S_DX]; dy = in[S_DY]; dz = in[S_DZ];
            tr = in[S_TR]; tg = in[S_TG]; tb = in[S_TB];
            time = in[S_TM];
            pix = __float_as_uint(in[S_PID]);
            smp = __float_as_uint(in[S_SID]);
            rr = 0.f; rg = 0.f; rb = 0.f;
          } else if (lead) {
            // dead at entry: the row passes through and adds nothing (a
            // live row with no bounce to trace leaves alive, as 1)
            float* out = p.state_out + (size_t)ray * SW;
#pragma unroll
            for (int c = 0; c < SW; ++c) out[c] = in[c];
            if (al_in > 0.5f) out[S_AL] = 1.0f;
            if (p.accum == nullptr) {
              p.rad[ray] = 0.f;
              p.rad[m + ray] = 0.f;
              p.rad[2 * m + ray] = 0.f;
            }
            if (WANT_WINNERS) {
              for (int bb = 0; bb < p.n_bounces; ++bb) p.winners[(size_t)bb * m + ray] = -1;
            }
          }
        }
      }
    }
    const bool active = i >= 0;
    if (__ballot_sync(FULL, active) == 0) break;

    // ---- closest hit over all primitives (megakernel.py:535-586) ----
    const float o_d = ox * dx + oy * dy + oz * dz;
    const float o_o = ox * ox + oy * oy + oz * oz;
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    float best = BIG;
    int idx = INT_MAX;
    if (active) {
      const float f[NF] = {dx, dy, dz, time * dx, time * dy, time * dz, o_d,
                           ox, oy, oz, time * ox, time * oy, time * oz,
                           time, time * time, o_o, 1.0f};
      scan_share(s_coef, S, R, p.s_live, p.r_live, k, G, f, a, inv_a, t_min, best, idx);
    }
    // the group's winner: smaller t first, the lower index on equal t
    for (int off = stride; off < 32; off <<= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, idx, off);
      if (ob < best || (ob == best && oi < idx)) { best = ob; idx = oi; }
    }
    if (!active) continue;

    const bool hit = best < BIG * 0.5f;
    if (WANT_WINNERS && lead) p.winners[(size_t)b * m + i] = hit ? idx : -1;
    const float t_eff = hit ? best : 1.0f;
    const float px = ox + t_eff * dx;
    const float py = oy + t_eff * dy;
    const float pz = oz + t_eff * dz;

    // ---- winner attributes (megakernel.py:601-631) ----
    const size_t j = (size_t)(hit ? idx : 0);
    const bool is_s = (int)j < S;
    float cx = __ldg(af + AF_C0X * ast + j);
    float cy = __ldg(af + AF_C0Y * ast + j);
    float cz = __ldg(af + AF_C0Z * ast + j);
    if (HAS_MOTION) {
      const float s_t = (time - __ldg(af + AF_T0 * ast + j)) * __ldg(af + AF_IDT * ast + j);
      cx = cx + s_t * __ldg(af + AF_DCX * ast + j);
      cy = cy + s_t * __ldg(af + AF_DCY * ast + j);
      cz = cz + s_t * __ldg(af + AF_DCZ * ast + j);
    }
    const float inv_r = __ldg(af + AF_INVR * ast + j);
    const float fuzz = __ldg(af + AF_FUZZ * ast + j);
    const float ior = __ldg(af + AF_IOR * ast + j);
    const int mtype = __ldg(ai + AI_MTYPE * ast + j);
    const int ttype = __ldg(ai + AI_TTYPE * ast + j);

    // outward normal: sphere (p - c)/r, rect table normal
    const float onx = is_s ? (px - cx) * inv_r : __ldg(af + AF_NX * ast + j);
    const float ony = is_s ? (py - cy) * inv_r : __ldg(af + AF_NY * ast + j);
    const float onz = is_s ? (pz - cz) * inv_r : __ldg(af + AF_NZ * ast + j);
    const float d_dot_n = dx * onx + dy * ony + dz * onz;
    const bool front = d_dot_n < 0.f;
    const float sgn = front ? 1.f : -1.f;
    const float nx = onx * sgn, ny = ony * sgn, nz = onz * sgn;

    // ---- RNG (megakernel.py:645-665), streams of this ray's own bounce ----
    const uint32_t stream_a = BOUNCE_STREAM0 + 2u * (uint32_t)(p.b0 + b);
    uint32_t x0 = pix, y0 = smp, z0 = stream_a, w0 = p.seed;
    pcg4d(x0, y0, z0, w0);
    uint32_t x1 = pix, y1 = smp, z1 = stream_a + 1u, w1 = p.seed;
    pcg4d(x1, y1, z1, w1);
    const float ua0 = to_unit(x0), ua1 = to_unit(y0);
    const float ua2 = to_unit(z0), ua3 = to_unit(w0);
    const float ub0 = to_unit(x1), ub1 = to_unit(y1);
    const float two_pi = 6.283185307179586f;
    const float g_r0 = sqrtf(-2.0f * log1pf(-ua0));
    const float g_r1 = sqrtf(-2.0f * log1pf(-ua2));
    const float g0 = g_r0 * cosf(two_pi * ua1);
    const float g1 = g_r0 * sinf(two_pi * ua1);
    const float g2 = g_r1 * cosf(two_pi * ua3);
    const float g_sq = g0 * g0 + g1 * g1 + g2 * g2;
    const bool g_zero = sqrtf(g_sq) == 0.f;
    const float inv_g = 1.0f / sqrtf(g_zero ? 1.0f : g_sq);
    const float uvx = g_zero ? g0 : g0 * inv_g;
    const float uvy = g_zero ? g1 : g1 * inv_g;
    const float uvz = g_zero ? g2 : g2 * inv_g;
    const float crad = expf(logf(fmaxf(ub0, 1e-30f)) * (1.0f / 3.0f));

    // ---- texture (solid / checker) ----
    const float sines = sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
    const bool use2 = (ttype == TEX_CHECKER) && (sines < 0.f);
    float tex_r = __ldg(af + (use2 ? AF_C2R : AF_CR) * ast + j);
    float tex_g = __ldg(af + (use2 ? AF_C2G : AF_CG) * ast + j);
    float tex_b = __ldg(af + (use2 ? AF_C2B : AF_CB) * ast + j);
    // noise and image: only for a live hit on their own texture type (the
    // ray is alive here); the TPU kernel's per-tile lax.cond skip becomes
    // this per-ray branch (megakernel.py:676-786)
    if (HAS_NOISE && hit && ttype == TEX_NOISE) {
      const float turb = perlin_turb(p.perm, p.grad, px, py, pz);
      const float gray =
          0.5f * (1.0f + sinf(__ldg(af + AF_TSCALE * ast + j) * pz + 10.0f * turb));
      tex_r = gray; tex_g = gray; tex_b = gray;
    }
    if (HAS_IMAGE && hit && ttype == TEX_IMAGE) {
      const float3 c = image_rgb(af, ai, ast, j, is_s, p.images, onx, ony, onz, px, py, pz);
      tex_r = c.x; tex_g = c.y; tex_b = c.z;
    }

    // ---- diffuse (material.zig:41-53) ----
    float ddx = nx + uvx, ddy = ny + uvy, ddz = nz + uvz;
    if (fabsf(ddx) < NEAR_ZERO && fabsf(ddy) < NEAR_ZERO && fabsf(ddz) < NEAR_ZERO) {
      ddx = nx; ddy = ny; ddz = nz;
    }

    // ---- metal (material.zig:55-66) ----
    const float d_nsq = dx * dx + dy * dy + dz * dz;
    const float inv_dn = 1.0f / sqrtf(d_nsq == 0.f ? 1.0f : d_nsq);
    const float ux = dx * inv_dn, uy = dy * inv_dn, uz = dz * inv_dn;
    const float u_dot_n = ux * nx + uy * ny + uz * nz;
    const float rx = ux - 2.0f * u_dot_n * nx;
    const float ry = uy - 2.0f * u_dot_n * ny;
    const float rz = uz - 2.0f * u_dot_n * nz;
    const float mdx = rx + fuzz * (uvx * crad);
    const float mdy = ry + fuzz * (uvy * crad);
    const float mdz = rz + fuzz * (uvz * crad);
    const bool metal_alive = (rx * nx + ry * ny + rz * nz) > 0.f;

    // ---- dielectric (material.zig:68-92) ----
    const float ratio = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-u_dot_n, 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-20f));
    const bool can_refract = ratio * sin_t <= 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    const float one_c = 1.0f - cos_t;
    float one_c5 = one_c * one_c;
    one_c5 = one_c5 * one_c5 * one_c;
    const float refl = r0 + (1.0f - r0) * one_c5;
    const bool do_refract = can_refract && (refl < ub1);
    const float perp_x = ratio * (ux + cos_t * nx);
    const float perp_y = ratio * (uy + cos_t * ny);
    const float perp_z = ratio * (uz + cos_t * nz);
    const float perp_sq = perp_x * perp_x + perp_y * perp_y + perp_z * perp_z;
    const float par = -sqrtf(fmaxf(fabsf(1.0f - perp_sq), 1e-12f));
    const float gdx = do_refract ? perp_x + par * nx : rx;
    const float gdy = do_refract ? perp_y + par * ny : ry;
    const float gdz = do_refract ? perp_z + par * nz : rz;

    // ---- select by material ----
    const bool is_metal = mtype == MAT_METAL;
    const bool is_diel = mtype == MAT_DIELECTRIC;
    const bool is_light = mtype == MAT_LIGHT;
    const float ndx = is_diel ? gdx : (is_metal ? mdx : ddx);
    const float ndy = is_diel ? gdy : (is_metal ? mdy : ddy);
    const float ndz = is_diel ? gdz : (is_metal ? mdz : ddz);
    const float at_r = is_diel ? 1.0f : tex_r;
    const float at_g = is_diel ? 1.0f : tex_g;
    const float at_b = is_diel ? 1.0f : tex_b;
    const bool sc_alive = (is_metal && metal_alive) || (!is_metal && !is_light);

    // ---- accumulate (main.zig:110-121); the ray is alive here ----
    const bool em = hit && is_light;
    float sky_r = p.bg_r, sky_g = p.bg_g, sky_b = p.bg_b;
    if (HAS_SKY) {
      // book-1 gradient sky (megakernel.py:861-870): inv_dn is the
      // reciprocal length of the CURRENT direction, after its guard
      const float tsky = 0.5f * (dy * inv_dn + 1.0f);
      sky_r = (1.0f - tsky) * p.bg_r + tsky * p.bg1_r;
      sky_g = (1.0f - tsky) * p.bg_g + tsky * p.bg1_g;
      sky_b = (1.0f - tsky) * p.bg_b + tsky * p.bg1_b;
    }
    rr = rr + (em ? tr * tex_r : 0.f) + (hit ? 0.f : tr * sky_r);
    rg = rg + (em ? tg * tex_g : 0.f) + (hit ? 0.f : tg * sky_g);
    rb = rb + (em ? tb * tex_b : 0.f) + (hit ? 0.f : tb * sky_b);
    const bool alive = hit && sc_alive;
    if (alive) {
      tr = tr * at_r; tg = tg * at_g; tb = tb * at_b;
      ox = px; oy = py; oz = pz;
      dx = ndx; dy = ndy; dz = ndz;
    }
    ++b;

    // ---- the ray is done: write it out, free the group ----
    if (!alive || b >= p.n_bounces) {
      if (lead) {
        if (WANT_WINNERS) {
          // dead rays take no decision: the rest of their column is -1
          for (int bb = b; bb < p.n_bounces; ++bb) p.winners[(size_t)bb * m + i] = -1;
        }
        const float* in = p.state_in + (size_t)i * SW;
        float* out = p.state_out + (size_t)i * SW;
        out[S_OX] = ox; out[S_OY] = oy; out[S_OZ] = oz;
        out[S_DX] = dx; out[S_DY] = dy; out[S_DZ] = dz;
        out[S_TM] = time;
        out[S_PID] = in[S_PID]; out[S_SID] = in[S_SID];
        out[S_TR] = tr; out[S_TG] = tg; out[S_TB] = tb;
        out[S_AL] = alive ? 1.0f : 0.0f;
        out[S_RID] = in[S_RID];
        if (p.accum != nullptr) {
          // the ray's own column: no other row of this launch adds there
          float* acc = p.accum + __float_as_int(in[S_RID]);
          const size_t cols = (size_t)p.accum_cols;
          acc[0] = __fadd_rn(acc[0], rr);
          acc[cols] = __fadd_rn(acc[cols], rg);
          acc[2 * cols] = __fadd_rn(acc[2 * cols], rb);
        } else {
          p.rad[i] = rr;
          p.rad[m + i] = rg;
          p.rad[2 * m + i] = rb;
        }
      }
      i = -1;
    }
  }
}

using KernelFn = void (*)(Params);

// Per (instantiation, device): the dynamic shared memory the kernel was
// allowed and its resident blocks an SM at a given table size, so that
// neither is queried from CUDA again for the same launch shape.
struct FnCache {
  KernelFn fn;
  int device;
  size_t smem_allowed;
  size_t occ_smem;
  int occ_blocks;
};
constexpr int N_CACHE = 64;
FnCache g_cache[N_CACHE];
int g_cached = 0;

cudaError_t prepare(KernelFn fn, size_t smem, FnCache** out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  FnCache* c = nullptr;
  for (int n = 0; n < g_cached; ++n)
    if (g_cache[n].fn == fn && g_cache[n].device == device) c = &g_cache[n];
  if (c == nullptr) {
    if (g_cached == N_CACHE) return cudaErrorMemoryAllocation;
    c = &g_cache[g_cached++];
    *c = FnCache{fn, device, 0, (size_t)-1, 0};
  }
  if (smem > c->smem_allowed) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    c->smem_allowed = smem;
  }
  *out = c;
  return cudaSuccess;
}

cudaError_t blocks_per_sm(KernelFn fn, size_t smem, int* blocks) {
  FnCache* c = nullptr;
  cudaError_t err = prepare(fn, smem, &c);
  if (err != cudaSuccess) return err;
  if (c->occ_smem != smem) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, BLOCK, smem);
    if (err != cudaSuccess) return err;
    c->occ_smem = smem;
    c->occ_blocks = n;
  }
  *blocks = c->occ_blocks;
  return cudaSuccess;
}

cudaError_t launch(KernelFn fn, const Params& p, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)p.n_rows * ROW_BYTES;
  FnCache* c = nullptr;
  cudaError_t err = prepare(fn, smem, &c);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(p.counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  fn<<<dim3((unsigned)blocks), BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instantiation for a variant mask: motion alone, none and image
// alone, and the general one for any other set (see the note at the top).
template <bool W>
KernelFn pick_kernel(int variant) {
  switch (variant) {
    case V_MOTION: return bounce_kernel<true, W, false, false, false>;
    case 0:        return bounce_kernel<false, W, false, false, false>;
    case V_IMAGE:  return bounce_kernel<false, W, false, true, false>;
    default:
      return (variant & V_SKY) ? bounce_kernel<true, W, true, true, true>
                               : bounce_kernel<true, W, true, true, false>;
  }
}

KernelFn pick_kernel(int variant, bool winners) {
  return winners ? pick_kernel<true>(variant) : pick_kernel<false>(variant);
}

// ---- camera ray generation ----
//
// raygen_kernel writes a render batch's initial state [m, SW], the rows
// that init_state(*generate_rays(...)) builds from PyTorch ops
// (ops/cuda/megakernel.py, ops/camera.py), in one launch that the host
// never waits on. It replaces no TPU kernel: the JAX package generates
// rays with jnp ops that XLA fuses (rtweekend_tpu/ops/camera.py). Eager
// PyTorch ran the same function as ~330 small launches a batch (PCG4D
// carried in masked int64) with host syncs between them.
//
// Row r < n is ray r of the batch: pixel p0 + r / n_samples, sample
// sample_start + r % n_samples (pixel-major, as ops/camera.batch_rays);
// rows n <= r < m are dead padding. The rows are bit-equal to what
// PyTorch's CUDA kernels compute for generate_rays + init_state. Each
// eager op rounds once, so every float op here is a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into an FMA. sqrtf, cosf and sinf are the accurate versions that
// PyTorch's kernels call (no fast math). A tensor divided by a Python
// float runs on the card as a multiply by the float32 reciprocal that
// PyTorch computes on the host: the wrapper passes it (inv_w, inv_h).
//
// Bound: 56 bytes written a row (45.4 MB for the 811,008 rows of a
// 1200x675 batch, 13.6 us at 3.35 TB/s) against ~150 arithmetic
// operations a row (two PCG4D hashes, a cosine and a sine, 25 float ops):
// the writes bound it. A block stages its 256 rows in shared memory, so
// that consecutive threads store consecutive words.
constexpr int RAYGEN_BLOCK = 256;
constexpr uint32_t STREAM_CAMERA0 = 0xC0FFEE00u;  // utils/rng.py
constexpr uint32_t STREAM_CAMERA1 = 0xC0FFEE01u;

struct RaygenParams {
  float* state;          // [m, SW]
  int n;                 // rays; rows n .. m - 1 are dead
  int m;
  int p0;                // the first pixel id
  int sample_start;
  int n_samples;         // samples a pixel
  int width;
  float inv_w, inv_h;    // float32 1 / float32(width - 1), and for height
  uint32_t seed;
  float origin[3], horizontal[3], vertical[3], lower_left[3], u[3], v[3];
  float lens_radius, time0, time1;
};

__global__ void __launch_bounds__(RAYGEN_BLOCK) raygen_kernel(const RaygenParams p) {
  __shared__ float rows[RAYGEN_BLOCK * SW];
  const int first = blockIdx.x * RAYGEN_BLOCK;
  const int r = first + (int)threadIdx.x;
  float* row = rows + threadIdx.x * SW;
  if (r < p.n) {
    const int pid = p.p0 + r / p.n_samples;
    const int sid = p.sample_start + r % p.n_samples;
    uint32_t x0 = (uint32_t)pid, y0 = (uint32_t)sid, z0 = STREAM_CAMERA0, w0 = p.seed;
    pcg4d(x0, y0, z0, w0);
    uint32_t x1 = (uint32_t)pid, y1 = (uint32_t)sid, z1 = STREAM_CAMERA1, w1 = p.seed;
    pcg4d(x1, y1, z1, w1);
    // generate_rays (ops/camera.py), op for op
    const float s = __fmul_rn(__fadd_rn((float)(pid % p.width), to_unit(x0)), p.inv_w);
    const float t = __fmul_rn(__fadd_rn((float)(pid / p.width), to_unit(y0)), p.inv_h);
    const float rad = sqrtf(to_unit(z0));
    const float theta = __fmul_rn((float)(2.0 * 3.141592653589793), to_unit(w0));
    const float rd0 = __fmul_rn(__fmul_rn(rad, cosf(theta)), p.lens_radius);
    const float rd1 = __fmul_rn(__fmul_rn(rad, sinf(theta)), p.lens_radius);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float off = __fadd_rn(__fmul_rn(p.u[k], rd0), __fmul_rn(p.v[k], rd1));
      row[S_OX + k] = __fadd_rn(p.origin[k], off);
      const float d = __fadd_rn(__fadd_rn(p.lower_left[k], __fmul_rn(s, p.horizontal[k])),
                                __fmul_rn(t, p.vertical[k]));
      row[S_DX + k] = __fsub_rn(__fsub_rn(d, p.origin[k]), off);
    }
    row[S_TM] = __fadd_rn(p.time0, __fmul_rn(to_unit(x1), __fsub_rn(p.time1, p.time0)));
    row[S_PID] = __int_as_float(pid);
    row[S_SID] = __int_as_float(sid);
    row[S_AL] = 1.0f;
  } else {
#pragma unroll
    for (int c = S_OX; c <= S_SID; ++c) row[c] = 0.0f;
    row[S_DZ] = 1.0f;
    row[S_AL] = 0.0f;
  }
  row[S_TR] = 1.0f;
  row[S_TG] = 1.0f;
  row[S_TB] = 1.0f;
  row[S_RID] = __int_as_float(r);
  __syncthreads();
  const int words = min(RAYGEN_BLOCK, p.m - first) * SW;
  float* out = p.state + (size_t)first * SW;
  for (int k = threadIdx.x; k < words; k += RAYGEN_BLOCK) out[k] = rows[k];
}

}  // namespace

// Plain C interface, bound with ctypes (ops/cuda/megakernel.py).
//
// rtw_bounce_blocks_per_sm: the resident blocks an SM of the instantiation
// for (variant, winners) at n_rows coefficient rows, on the current device;
// the wrapper multiplies it by the SM count for the persistent grid.
extern "C" int rtw_bounce_blocks_per_sm(int n_rows, int variant, int winners,
                                        int* blocks) {
  return (int)blocks_per_sm(pick_kernel(variant, winners != 0),
                            (size_t)n_rows * ROW_BYTES, blocks);
}

// rtw_bounce_segment: one launch of `blocks` persistent blocks of 256
// threads, `group` lanes a ray. Zeroes `counter` (one int32 of device
// memory, the next ray index) and launches on `stream`; allocates nothing,
// does not synchronise; returns the cudaError_t of the launch (0 on
// success). `variant` is a mask of 1 motion, 2 noise, 4 image, 8 gradient
// sky. `bg` holds six floats: the flat sky (or the gradient sky's bottom),
// then the gradient sky's top. `winners` is null for the radiance-only
// variant, else an [n_bounces, m] int32 buffer the kernel fills completely.
// `accum` is null for the radiance delta `rad` [3, m]; else it is a
// [3, accum_cols] float32 buffer, every live row's ray id lies in [0,
// accum_cols) and occurs in no other live row, each finished ray adds its
// radiance at its id, and `rad` is not touched (may be null).
extern "C" int rtw_bounce_segment(
    const void* coef, int n_rows, int coef_stride,
    const void* attr_f, const void* attr_i, int attr_stride,
    int s_pad, int r_pad, int s_live, int r_live, int variant,
    const void* perm, const void* grad, const void* images,
    const void* state_in, void* state_out, void* rad, void* accum, int accum_cols,
    void* winners, int m, unsigned int seed, float bg_r, float bg_g, float bg_b,
    float bg1_r, float bg1_g, float bg1_b,
    int b0, int n_bounces, float t_min,
    int group, int blocks, void* counter, void* stream) {
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.coef_stride = coef_stride;
  p.n_rows = n_rows;
  p.attr_f = static_cast<const float*>(attr_f);
  p.attr_i = static_cast<const int*>(attr_i);
  p.attr_stride = attr_stride;
  p.s_pad = s_pad;
  p.r_pad = r_pad;
  p.s_live = s_live;
  p.r_live = r_live;
  p.perm = static_cast<const int*>(perm);
  p.grad = static_cast<const float*>(grad);
  p.images = static_cast<const int*>(images);
  p.state_in = static_cast<const float*>(state_in);
  p.state_out = static_cast<float*>(state_out);
  p.rad = static_cast<float*>(rad);
  p.accum = static_cast<float*>(accum);
  p.accum_cols = accum_cols;
  p.winners = static_cast<int*>(winners);
  p.m = m;
  p.seed = seed;
  p.bg_r = bg_r;
  p.bg_g = bg_g;
  p.bg_b = bg_b;
  p.bg1_r = bg1_r;
  p.bg1_g = bg1_g;
  p.bg1_b = bg1_b;
  p.b0 = b0;
  p.n_bounces = n_bounces;
  p.t_min = t_min;
  p.group = group;
  p.counter = static_cast<int*>(counter);
  return (int)launch(pick_kernel(variant, winners != nullptr), p, blocks,
                     static_cast<cudaStream_t>(stream));
}

// rtw_raygen: one launch of raygen_kernel on `stream` over the m rows of
// `state` ([m, 14] float32 device memory); allocates nothing, does not
// synchronise, returns the cudaError_t of the launch. `camera` is a host
// array of 21 floats: origin, horizontal, vertical, lower_left, u, v (3
// each), lens_radius, time0, time1.
extern "C" int rtw_raygen(void* state, int n, int m, int p0, int sample_start,
                          int n_samples, int width, float inv_w, float inv_h,
                          unsigned int seed, const float* camera, void* stream) {
  if (n < 0 || m < n || m < 1 || n_samples < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  RaygenParams p;
  p.state = static_cast<float*>(state);
  p.n = n;
  p.m = m;
  p.p0 = p0;
  p.sample_start = sample_start;
  p.n_samples = n_samples;
  p.width = width;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  p.seed = seed;
  float* vecs[6] = {p.origin, p.horizontal, p.vertical, p.lower_left, p.u, p.v};
  for (int q = 0; q < 6; ++q)
    for (int k = 0; k < 3; ++k) vecs[q][k] = camera[3 * q + k];
  p.lens_radius = camera[18];
  p.time0 = camera[19];
  p.time1 = camera[20];
  const unsigned blocks = (unsigned)((m + RAYGEN_BLOCK - 1) / RAYGEN_BLOCK);
  raygen_kernel<<<blocks, RAYGEN_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
