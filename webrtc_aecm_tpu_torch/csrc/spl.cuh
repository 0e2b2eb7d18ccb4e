// Fixed-point SPL primitives for the CUDA kernels: the device-side twin of
// webrtc_aecm_tpu_torch/ops/spl.py (and of the JAX package's ops/spl.py).
//
// C integer semantics as the JAX package defines them: int32 arithmetic
// wraps mod 2^32 (done through uint32_t, so there is no signed-overflow
// UB), right shifts of negatives are arithmetic, shift counts that the JAX
// package masks `& 31` are masked here, division truncates toward zero.
// The TPU workarounds of the JAX module are not carried over: clz is
// __clz, division is the native integer divide.
#pragma once

#include <cstdint>

namespace aecm {

constexpr int WORD16_MAX = 32767;
constexpr int WORD16_MIN = -32768;
constexpr int WORD32_MAX = 0x7FFFFFFF;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (uint32_t)a); }

// C (int16_t) cast: keep the low 16 bits, sign-extend.
__device__ __forceinline__ int to_w16(int x) {
  return (int)(int16_t)(uint16_t)x;   // one sign-extending convert
}
__device__ __forceinline__ int sat_w16(int x) {
  return x > WORD16_MAX ? WORD16_MAX : (x < WORD16_MIN ? WORD16_MIN : x);
}
__device__ __forceinline__ int add_sat_w16(int a, int b) {
  return sat_w16(a + b);  // int16-range operands: no int32 overflow
}
__device__ __forceinline__ int add_sat_w32(int a, int b) {
  long long s = (long long)a + (long long)b;
  return s > WORD32_MAX ? WORD32_MAX
                        : (s < -(long long)WORD32_MAX - 1 ? (int)0x80000000
                                                           : (int)s);
}

// Leading zeros of a uint32; clz(0) = 32.
__device__ __forceinline__ int clz32(uint32_t x) { return __clz((int)x); }
__device__ __forceinline__ int norm_w32(int a) {
  return a == 0 ? 0 : clz32((uint32_t)(a < 0 ? ~a : a)) - 1;
}
__device__ __forceinline__ int norm_u32(uint32_t a) {
  return a == 0 ? 0 : clz32(a);
}
__device__ __forceinline__ int norm_w16(int a) {
  return a == 0 ? 0 : clz32((uint32_t)(a < 0 ? ~a : a)) - 17;
}

__device__ __forceinline__ int shl_i32(int x, int c) {
  return (int)((uint32_t)x << (c & 31));
}
__device__ __forceinline__ int sar_i32(int x, int c) { return x >> (c & 31); }
__device__ __forceinline__ uint32_t shl_u32(uint32_t x, int c) {
  return x << (c & 31);
}
// WEBRTC_SPL_SHIFT_W32: c >= 0 shifts left (wrapping), c < 0 right.
__device__ __forceinline__ int shift_w32(int x, int c) {
  return c >= 0 ? shl_i32(x, c) : (x >> ((-c) & 31));
}
__device__ __forceinline__ uint32_t shift_w32_u(uint32_t x, int c) {
  return c >= 0 ? (x << (c & 31)) : (x >> ((-c) & 31));
}

// (int64(x) * mult) >> shift (the echoFilt IIR, aecm_core_c.cc:524).
__device__ __forceinline__ int mul_i64_shift_right(int x, int mult,
                                                   int shift) {
  return (int)(((long long)x * mult) >> shift);
}

// WebRtcSpl_DivW32W16: trunc(num / den) wrapped to int32, WORD32_MAX on 0.
__device__ __forceinline__ int div_w32_w16(int num, int den) {
  if (den == 0) return WORD32_MAX;
  if (den == -1) return wneg(num);   // the one quotient that leaves int32
  return num / den;                  // a 32-bit divide, not a 64-bit one
}
// WebRtcSpl_DivU32U16: floor(num / den), 0xFFFFFFFF on 0.
__device__ __forceinline__ uint32_t div_u32_u16(uint32_t num, uint32_t den) {
  return den == 0 ? 0xFFFFFFFFu : num / den;
}

// WebRtcSpl_SqrtFloor: floor(sqrt(v)) for v >= 0, 0 for v < 0.
__device__ __forceinline__ int sqrt_floor(int v) {
  if (v <= 0) return 0;
  // float32 holds v to 2^-24 and sqrtf rounds to nearest, so the estimate
  // is within 1 of the root (r <= 46341: no overflow below); fix it up
  uint32_t r = (uint32_t)sqrtf((float)v);
  if ((r + 1) * (r + 1) <= (uint32_t)v) r += 1;
  if (r * r > (uint32_t)v) r -= 1;
  return (int)r;
}

// WebRtc_MeanEstimatorFix (delay_estimator.cc:690-702).
__device__ __forceinline__ int mean_estimator_fix(int new_value, int factor,
                                                  int mean_value) {
  int diff = wsub(new_value, mean_value);
  int step = diff < 0 ? wneg(wneg(diff) >> factor) : (diff >> factor);
  return wadd(mean_value, step);
}

}  // namespace aecm
