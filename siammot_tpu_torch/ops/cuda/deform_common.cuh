// The deformable conv's sampling, shared by its forward (deform.cu) and
// its backward (deform_bwd.cu): each (pixel, tap)'s four corners and
// coefficients by either reference route, and one bilinear sample in the
// route's arithmetic (ops/deform_conv.py's docstring says which rounding
// each route has).
#pragma once

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Geometry {
  int B, H, W, C, Ho, Wo, Co, stride, dil;
};

// The four corners of one (pixel, tap) sample: element offsets of the
// corner's channel 0 in x (-1 out of range) and the route's coefficients
// (route A: 1 - fy, fy, cx0, cx1; route B: w00, w01, w10, w11).
//
// Route B's fractions: JAX takes coordinate - floor in the offsets' dtype,
// and in bf16 that rounds where the coordinate lies in (-0.5, 0) with
// bits below 2^-8 (-0.3379 gives 0.6621, rounded to 0.6641); so do the
// forward and the backward here, bit for bit the plain version.
struct Corners {
  int at[4];
  float k[4];
  float f[2];  // route B: the fractions fy, fx
};

template <typename T>
__device__ Corners corners(const T* __restrict__ off, const Geometry& g,
                           int n, int tap, bool route_a) {
  const int b = n / (g.Ho * g.Wo), rem = n % (g.Ho * g.Wo);
  const int py = rem / g.Wo, px = rem % g.Wo;
  const int gy = py * g.stride - g.dil + (tap / 3) * g.dil;
  const int gx = px * g.stride - g.dil + (tap % 3) * g.dil;
  const float oy = load_f32(off, (size_t)n * 18 + 2 * tap);
  const float ox = load_f32(off, (size_t)n * 18 + 2 * tap + 1);
  Corners r;
  int y0, x0;
  if (route_a) {
    // relative floor and fraction (exact); column weights rounded to the
    // input dtype, row weights f32, as the Pallas kernel's one-hot
    // matmul and row blend
    const float fly = floorf(oy), flx = floorf(ox);
    const float fy = oy - fly, fx = ox - flx;
    y0 = gy + (int)fly;
    x0 = gx + (int)flx;
    r.k[0] = __fsub_rn(1.f, fy);
    r.k[1] = fy;
    r.k[2] = rnd<T>(__fsub_rn(1.f, fx));
    r.k[3] = rnd<T>(fx);
  } else {
    // absolute coordinate in the offsets' dtype (int + bf16 -> bf16 in
    // JAX), corner weights as products in the input dtype
    const float cy = rnd<T>(rnd<T>((float)gy) + oy);
    const float cx = rnd<T>(rnd<T>((float)gx) + ox);
    const float fly = floorf(cy), flx = floorf(cx);
    const float fy = rnd<T>(cy - fly), fx = rnd<T>(cx - flx);
    y0 = (int)fly;
    x0 = (int)flx;
    const float ay = rnd<T>(1.f - fy), ax = rnd<T>(1.f - fx);
    r.k[0] = rnd<T>(ay * ax);
    r.k[1] = rnd<T>(ay * fx);
    r.k[2] = rnd<T>(fy * ax);
    r.k[3] = rnd<T>(fy * fx);
    r.f[0] = fy;
    r.f[1] = fx;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int yy = y0 + i / 2, xx = x0 + i % 2;
    r.at[i] = (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
                  ? ((b * g.H + yy) * g.W + xx) * g.C
                  : -1;
  }
  return r;
}

// one sample from its four corner values, in the route's arithmetic,
// before its rounding to the input dtype
__device__ __forceinline__ float blend(const float* v, const float* k,
                                       bool route_a) {
  if (route_a) {
    const float p0 = __fadd_rn(__fmul_rn(k[2], v[0]), __fmul_rn(k[3], v[1]));
    const float p1 = __fadd_rn(__fmul_rn(k[2], v[2]), __fmul_rn(k[3], v[3]));
    return __fadd_rn(__fmul_rn(k[0], p0), __fmul_rn(k[1], p1));
  }
  float s = __fmul_rn(k[0], v[0]);
  s = __fadd_rn(s, __fmul_rn(k[1], v[1]));
  s = __fadd_rn(s, __fmul_rn(k[2], v[2]));
  return __fadd_rn(s, __fmul_rn(k[3], v[3]));
}

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ x,
                                        const int* at, const float* k, int c,
                                        bool route_a) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = at[i] >= 0 ? load_f32(x, at[i] + c) : 0.f;
  return rnd<T>(blend(v, k, route_a));
}

}  // namespace
