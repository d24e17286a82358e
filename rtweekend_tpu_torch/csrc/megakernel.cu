// Bounce megakernel for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel rtweekend_tpu/ops/pallas/megakernel.py:_make_kernel, launched
// there by _trace_segment (pl.pallas_call at megakernel.py:1050).
//
// What it computes: for every ray of the buffer, up to n_bounces path-
// tracing bounces starting at global bounce b0 — closest hit over all
// 2S+6R coefficient rows (min t, lowest index on ties), the winner's
// attributes, PCG4D draws at streams BOUNCE_STREAM0+2(b0+b) and +1,
// Lambertian / metal / dielectric scatter with the checker texture, and
// the flat-sky / emission radiance update. It emits the segment's
// radiance delta [3, m] and the carried state [m, 14]. Rays dead at entry
// pass through untouched. Variants, as template instantiations:
// has_motion true (final_scene) and false (cornell_box); want_winners
// (megakernel.py:892, :902-903) also writes winners [n_bounces, m] int32,
// the closest-hit primitive of every bounce (spheres 0..S-1, then rects
// S..S+R-1), -1 on a miss and on every bounce after the ray died — the
// path decisions the differentiable replay (ops/replay.py) re-traces.
// Perlin noise, image textures and the gradient sky are not here (the
// Python wrapper refuses scenes that need them).
//
// Design, simple and correct before fast: one thread per ray, the bounce
// loop inside the thread, a strict `t < best` scan over the primitives
// (lowest index wins a tie, like megakernel.py:576-581). The coefficient
// rows are staged once per block into dynamic shared memory as 5 float4
// (17 used columns + 3 zero columns of the table): every thread of a warp
// reads the same row at the same time, a broadcast, and the float4 form
// needs 5 loads per 17 FMAs. final_scene's 1024 rows take 80 KB, above
// the 48 KB default, hence cudaFuncSetAttribute. Winner attributes are
// read from device memory through the read-only cache (__ldg), once per
// bounce. The winners write is one int per ray-bounce, coalesced across
// the warp (row b of winners is contiguous in the ray index); with
// WANT_WINNERS false it compiles away, so the render path's code is
// unchanged.
//
// Numerics: fp32 only, no tensor cores, no fast-math. The sphere c_coef
// row cancels |beta|^2 ~ 1e6 (r = 1000 ground) to ~1e3, so reduced
// precision flips closest hits; logf/log1pf/sinf/cosf/expf/sqrtf are the
// accurate versions, division and sqrt IEEE-rounded, rsqrt written as
// 1/sqrtf, and the cube root of the fuzz radius is expf(logf(max(u,
// 1e-30))/3) as in the TPU kernel (megakernel.py:665). PCG4D runs natively
// in uint32 and is bit-equal to rtweekend_tpu/utils/rng.py.
//
// Bound on this card: per live ray-bounce, (2S+6R)*17 fp32 multiply-adds
// for the coefficient dots (final_scene: 1024*17 = 17,408 FMA) plus a
// ~10-op epilogue per primitive and a few hundred shading ops, against
// 67 TFLOP/s fp32 outside the tensor cores; the state traffic (2 x 56
// bytes per ray per launch) is far below the memory bound; so is the
// winners output (4 bytes per ray-bounce: 162 MB for 811,008 rays at depth
// 50, ~0.05 ms at 3.35 TB/s). This first version makes no attempt to
// approach the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 17;
constexpr int ROW_F4 = 5;   // one coefficient row in shared memory: 5 float4
constexpr int BLOCK = 256;
constexpr int SW = 14;      // state row width, see ops/cuda/megakernel.py
enum { S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_TM, S_PID, S_SID,
       S_TR, S_TG, S_TB, S_AL, S_RID };
// attribute rows (megakernel.py:158-175)
enum { AF_C0X, AF_C0Y, AF_C0Z, AF_DCX, AF_DCY, AF_DCZ, AF_T0, AF_IDT,
       AF_INVR, AF_NX, AF_NY, AF_NZ, AF_FUZZ, AF_IOR,
       AF_CR, AF_CG, AF_CB, AF_C2R, AF_C2G, AF_C2B };
enum { AI_MTYPE, AI_TTYPE };
constexpr int MAT_METAL = 1;
constexpr int MAT_DIELECTRIC = 2;
constexpr int MAT_LIGHT = 3;
constexpr int TEX_CHECKER = 1;
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
  const float* state_in; // [m, SW]
  float* state_out;      // [m, SW]
  float* rad;            // [3, m]
  int* winners;          // [n_bounces, m] when WANT_WINNERS, else null
  int m;
  uint32_t seed;
  float bg_r, bg_g, bg_b;
  int b0;
  int n_bounces;
  float t_min;
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

template <bool HAS_MOTION, bool WANT_WINNERS>
__global__ void __launch_bounds__(BLOCK) bounce_kernel(const Params p) {
  extern __shared__ float4 s_coef[];
  const int n_f4 = p.n_rows * ROW_F4;
  for (int k = threadIdx.x; k < n_f4; k += blockDim.x) {
    const int r = k / ROW_F4;
    const int q = k - r * ROW_F4;
    s_coef[k] = __ldg(
        reinterpret_cast<const float4*>(p.coef + (size_t)r * p.coef_stride) + q);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.m) return;

  const float* in = p.state_in + (size_t)i * SW;
  float ox = in[S_OX], oy = in[S_OY], oz = in[S_OZ];
  float dx = in[S_DX], dy = in[S_DY], dz = in[S_DZ];
  float tr = in[S_TR], tg = in[S_TG], tb = in[S_TB];
  const float time = in[S_TM];
  const float al_in = in[S_AL];
  const uint32_t pix = __float_as_uint(in[S_PID]);
  const uint32_t smp = __float_as_uint(in[S_SID]);
  const bool alive_in = al_in > 0.5f;
  bool alive = alive_in;
  float rr = 0.f, rg = 0.f, rb = 0.f;

  const int S = p.s_pad;
  const int R = p.r_pad;
  const float t_min = p.t_min;
  const float4* rect_rows = s_coef + 2 * S * ROW_F4;
  const float* af = p.attr_f;
  const int* ai = p.attr_i;
  const size_t ast = (size_t)p.attr_stride;

  int b = 0;
  for (; b < p.n_bounces && alive; ++b) {
    // ---- closest hit over all primitives (megakernel.py:535-586) ----
    const float o_d = ox * dx + oy * dy + oz * dz;
    const float o_o = ox * ox + oy * oy + oz * oz;
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    const float f[NF] = {dx, dy, dz, time * dx, time * dy, time * dz, o_d,
                         ox, oy, oz, time * ox, time * oy, time * oz,
                         time, time * time, o_o, 1.0f};
    float best = BIG;
    int idx = 0;
    for (int s = 0; s < S; ++s) {
      const float hb = dot_row(s_coef + s * ROW_F4, f);
      const float cc = dot_row(s_coef + (S + s) * ROW_F4, f);
      const float disc = hb * hb - a * cc;
      float t = BIG;
      if (disc > 0.f) {  // coeffs.quadratic_t
        const float sq = sqrtf(disc);
        const float root1 = -(hb + sq) * inv_a;
        const float root2 = (sq - hb) * inv_a;
        const float t12 = root1 >= t_min ? root1 : root2;
        if (t12 >= t_min) t = t12;
      }
      if (t < best) { best = t; idx = s; }
    }
    for (int r = 0; r < R; ++r) {
      const float kn = dot_row(rect_rows + r * ROW_F4, f);
      const float dn = dot_row(rect_rows + (R + r) * ROW_F4, f);
      float t = BIG;
      if (dn != 0.f) {  // coeffs.rect_t
        const float tt = kn / dn;
        const float u = dot_row(rect_rows + (2 * R + r) * ROW_F4, f)
                      + tt * dot_row(rect_rows + (3 * R + r) * ROW_F4, f);
        const float v = dot_row(rect_rows + (4 * R + r) * ROW_F4, f)
                      + tt * dot_row(rect_rows + (5 * R + r) * ROW_F4, f);
        if (tt >= t_min && u >= 0.f && u <= 1.f && v >= 0.f && v <= 1.f) t = tt;
      }
      if (t < best) { best = t; idx = S + r; }
    }
    const bool hit = best < BIG * 0.5f;
    if (WANT_WINNERS) p.winners[(size_t)b * p.m + i] = hit ? idx : -1;
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

    // ---- RNG (megakernel.py:645-665) ----
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
    const float tex_r = __ldg(af + (use2 ? AF_C2R : AF_CR) * ast + j);
    const float tex_g = __ldg(af + (use2 ? AF_C2G : AF_CG) * ast + j);
    const float tex_b = __ldg(af + (use2 ? AF_C2B : AF_CB) * ast + j);

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
    rr = rr + (em ? tr * tex_r : 0.f) + (hit ? 0.f : tr * p.bg_r);
    rg = rg + (em ? tg * tex_g : 0.f) + (hit ? 0.f : tg * p.bg_g);
    rb = rb + (em ? tb * tex_b : 0.f) + (hit ? 0.f : tb * p.bg_b);
    alive = hit && sc_alive;
    if (alive) {
      tr = tr * at_r; tg = tg * at_g; tb = tb * at_b;
      ox = px; oy = py; oz = pz;
      dx = ndx; dy = ndy; dz = ndz;
    }
  }

  if (WANT_WINNERS) {
    // dead rays take no decision: the rest of their column is -1
    for (; b < p.n_bounces; ++b) p.winners[(size_t)b * p.m + i] = -1;
  }

  float* out = p.state_out + (size_t)i * SW;
  out[S_OX] = ox; out[S_OY] = oy; out[S_OZ] = oz;
  out[S_DX] = dx; out[S_DY] = dy; out[S_DZ] = dz;
  out[S_TM] = time;
  out[S_PID] = in[S_PID]; out[S_SID] = in[S_SID];
  out[S_TR] = tr; out[S_TG] = tg; out[S_TB] = tb;
  out[S_AL] = alive_in ? (alive ? 1.0f : 0.0f) : al_in;
  out[S_RID] = in[S_RID];
  p.rad[i] = rr;
  p.rad[(size_t)p.m + i] = rg;
  p.rad[2 * (size_t)p.m + i] = rb;
}

template <bool HAS_MOTION, bool WANT_WINNERS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.n_rows * ROW_F4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_kernel<HAS_MOTION, WANT_WINNERS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.m + BLOCK - 1) / BLOCK));
  bounce_kernel<HAS_MOTION, WANT_WINNERS><<<grid, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ops/cuda/megakernel.py). Launches
// on `stream`, allocates nothing, does not synchronise; returns the
// cudaError_t of the launch (0 on success). `winners` is null for the
// radiance-only variant, else an [n_bounces, m] int32 buffer the kernel
// fills completely.
extern "C" int rtw_bounce_segment(
    const void* coef, int n_rows, int coef_stride,
    const void* attr_f, const void* attr_i, int attr_stride,
    int s_pad, int r_pad, int has_motion,
    const void* state_in, void* state_out, void* rad, void* winners, int m,
    unsigned int seed, float bg_r, float bg_g, float bg_b,
    int b0, int n_bounces, float t_min, void* stream) {
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.coef_stride = coef_stride;
  p.n_rows = n_rows;
  p.attr_f = static_cast<const float*>(attr_f);
  p.attr_i = static_cast<const int*>(attr_i);
  p.attr_stride = attr_stride;
  p.s_pad = s_pad;
  p.r_pad = r_pad;
  p.state_in = static_cast<const float*>(state_in);
  p.state_out = static_cast<float*>(state_out);
  p.rad = static_cast<float*>(rad);
  p.winners = static_cast<int*>(winners);
  p.m = m;
  p.seed = seed;
  p.bg_r = bg_r;
  p.bg_g = bg_g;
  p.bg_b = bg_b;
  p.b0 = b0;
  p.n_bounces = n_bounces;
  p.t_min = t_min;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (winners != nullptr) {
    err = has_motion ? launch<true, true>(p, s) : launch<false, true>(p, s);
  } else {
    err = has_motion ? launch<true, false>(p, s) : launch<false, false>(p, s);
  }
  return (int)err;
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
