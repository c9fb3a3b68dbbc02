// Device helpers shared by the decode kernels (decode_cluster.cuh, whose step
// body decode_generate.cu and decode_segment.cu run, spec_decode.cu and the
// wide kernels): block reductions, vector loads, the bf16/f32 conversions,
// tanh-GELU, LayerNorm, the Philox4x32-10 Gumbel noise, the sampling of one
// row of logits and the optional phase clock. All kernels draw the same bits
// from one definition, so the speculative, segmented and wide kernels'
// samples equal the sequential kernel's.
//
// Every block that uses these runs kThreads threads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace decode_common {

constexpr int kThreads = 512;  // KERNEL_THREADS in ops/decode_kernel_batched.py
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;

// The shared memory a kernel's static __shared__ variables take from
// kMaxSharedBytes: the dynamic buffer starts after them at a 16-byte
// boundary (ptxas reports the padded size).
constexpr int static_shared_bytes(int bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

struct Add {
  template <typename V> __device__ __forceinline__ V operator()(V a, V b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};

// op over the block; every thread gets the same result (fixed order).
// identity fills the lanes past the last warp.
template <typename V, typename Op>
__device__ inline V block_reduce(V v, V* red, V identity, Op op) {
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  V t = lane < kWarps ? red[lane] : identity;
  for (int o = 16; o; o >>= 1) t = op(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

__device__ inline float block_sum(float v, float* red) { return block_reduce(v, red, 0.f, Add()); }
__device__ inline double block_sum_double(double v, double* red) {
  return block_reduce(v, red, 0.0, Add());
}
__device__ inline float block_max(float v, float* red) {
  return block_reduce(v, red, -CUDART_INF_F, Max());
}
__device__ inline int block_max_int(int v, int* red) { return block_reduce(v, red, -1, Max()); }

// Index of the first maximum of x[0, n) (== torch/jnp argmax).
__device__ inline int block_argmax(const float* x, int n, float* red) {
  float best = -CUDART_INF_F;
  int index = n;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    if (x[v] > best) { best = x[v]; index = v; }
  }
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, index, o);
    if (ob > best || (ob == best && oi < index)) { best = ob; index = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* red_i = reinterpret_cast<int*>(red + kWarps);
  __syncthreads();
  if (lane == 0) { red[warp] = best; red_i[warp] = index; }
  __syncthreads();
  best = lane < kWarps ? red[lane] : -CUDART_INF_F;
  index = lane < kWarps ? red_i[lane] : n;
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, index, o);
    if (ob > best || (ob == best && oi < index)) { best = ob; index = oi; }
  }
  return index;
}

// 16-byte vector loads: Vec<T>::N consecutive elements as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pairs[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

// Four consecutive elements as floats (16 bytes of float32, 8 of bf16).
template <typename T> struct Vec4;
template <> struct Vec4<float> : Vec<float> {};
template <> struct Vec4<__nv_bfloat16> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

// q_h . row[0, D) with D a multiple of Vec<T>::N.
template <typename T>
__device__ __forceinline__ float head_dot(const float* q, const T* row, int D) {
  constexpr int VN = Vec<T>::N;
  float acc = 0.f;
  for (int d = 0; d < D; d += VN) {
    float v[VN];
    Vec<T>::load(row + d, v);
#pragma unroll
    for (int c = 0; c < VN; ++c) acc = fmaf(q[d + c], v[c], acc);
  }
  return acc;
}

// Two LayerNorms: out = (x - mean) * rsqrt(var + eps) [* scale + bias] and
// xw = out rounded to T; out may be null. layer_norm spreads its one row over
// the whole block (decode_generate: one row per step); layer_norm_rows gives
// each of several rows a warp (spec_decode: T rows per block). One warp for
// one row serialises the row's loads: decode_generate ran about 1.4-1.5x
// slower with layer_norm_rows(rows = 1) on an H100 (PERF.md).
template <typename T>
__device__ void layer_norm(const float* x, float* out, float* xw, int n, float eps,
                           const float* scale, const float* bias, float* red) {
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) s += x[e];
  const float mean = block_sum(s, red) / n;
  float q = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float c = x[e] - mean;
    q += c * c;
  }
  const float r = rsqrtf(block_sum(q, red) / n + eps);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float y = (x[e] - mean) * r;
    if (scale != nullptr) y = y * scale[e] + bias[e];
    if (out != nullptr) out[e] = y;
    xw[e] = round_to<T>(y);
  }
  __syncthreads();
}

// Rows r < rows of x, out and xw at stride n.
template <typename T>
__device__ void layer_norm_rows(const float* x, float* out, float* xw, int rows, int n,
                                float eps, const float* scale, const float* bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = x + r * n;
    float s = 0.f;
    for (int e = lane; e < n; e += 32) s += xr[e];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / n;
    float q = 0.f;
    for (int e = lane; e < n; e += 32) {
      const float c = xr[e] - mean;
      q += c * c;
    }
    for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / n + eps);
    for (int e = lane; e < n; e += 32) {
      float y = (xr[e] - mean) * rstd;
      if (scale != nullptr) y = y * scale[e] + bias[e];
      if (out != nullptr) out[r * n + e] = y;
      xw[r * n + e] = round_to<T>(y);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A kernel's optional clock (phase_ns in the wrappers of decode_wide,
// decode_segment_wide and spec_decode): block 0's thread 0 adds the time
// since its last mark to the phase kind it marks. Marked right after a
// barrier, a phase's time is the slowest block's work plus the barrier. The
// phase kinds are each wrapper's PHASES.
struct PhaseClock {
  unsigned long long* slots;
  bool on;
  unsigned long long last;
  __device__ explicit PhaseClock(unsigned long long* clock)
      : slots(clock), on(clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0),
        last(on ? global_ns() : 0) {}
  __device__ __forceinline__ void mark(int phase) {
    if (on) {
      const unsigned long long now = global_ns();
      slots[phase] += now - last;
      last = now;
    }
  }
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, ctr.x), lo0 = 0xD2511F53u * ctr.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, ctr.z), lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

__device__ __forceinline__ float gumbel(unsigned bits) {
  const float u = (float)(bits >> 9) * (1.0f / 8388608.0f) + 1e-12f;
  return -logf(-logf(u));
}

// The next token from one row of logits[0, V): the first argmax when
// temp <= 0; else logits / temp, top-k / top-p (both on the unfiltered
// scaled row, ties kept; a disabled filter carries its sentinel, topk V+1
// and topp 2.0), plus Gumbel noise, then the first argmax. Lane v draws word
// v % 4 of Philox(counter (v / 4, step, row, 0), key (seed, 0)). scaled,
// scored and expv are V floats of shared scratch each. Every thread returns
// the same index.
__device__ inline int sample_row(const float* logits, float* scaled, float* scored, float* expv,
                                 int V, float temp, float topk, float topp, unsigned seed,
                                 unsigned step, unsigned row, float* red) {
  const int tid = threadIdx.x;
  if (!(temp > 0.f)) return block_argmax(logits, V, red);
  const float inv_temp = 1.0f / temp;
  for (int v = tid; v < V; v += kThreads) scaled[v] = logits[v] * inv_temp;
  __syncthreads();
  const bool do_k = topk < (float)V;
  const bool do_p = topp < 1.0f;
  double z = 0.0;
  if (do_p) {
    float local_max = -CUDART_INF_F;
    for (int v = tid; v < V; v += kThreads) local_max = fmaxf(local_max, scaled[v]);
    const float m = block_max(local_max, red);
    double local = 0.0;
    for (int v = tid; v < V; v += kThreads) {
      const float ev = expf(scaled[v] - m);
      expv[v] = ev;
      local += (double)ev;
    }
    z = block_sum_double(local, reinterpret_cast<double*>(red));
  }
  __syncthreads();
  for (int v = tid; v < V; v += kThreads) {
    const float xv = scaled[v];
    bool keep = true;
    if (do_k || do_p) {
      int rank = 0;
      double mass = 0.0;
      for (int j = 0; j < V; ++j) {
        if (scaled[j] > xv) {
          ++rank;
          if (do_p) mass += (double)expv[j];
        }
      }
      if (do_k) keep = keep && ((float)rank < topk);
      if (do_p) keep = keep && (mass / z < (double)topp);
    }
    scored[v] = keep ? xv : kNegInf;
  }
  __syncthreads();
  for (int c = tid; c < V / 4; c += kThreads) {
    const uint4 r = philox4x32_10(make_uint4((unsigned)c, step, row, 0u), make_uint2(seed, 0u));
    scored[4 * c + 0] += gumbel(r.x);
    scored[4 * c + 1] += gumbel(r.y);
    scored[4 * c + 2] += gumbel(r.z);
    scored[4 * c + 3] += gumbel(r.w);
  }
  __syncthreads();
  return block_argmax(scored, V, red);
}

}  // namespace decode_common
