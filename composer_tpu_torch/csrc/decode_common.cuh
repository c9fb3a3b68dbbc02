// Device helpers shared by the decode kernels (decode_generate.cu,
// decode_segment.cu and spec_decode.cu): block reductions, vector loads, the
// bf16/f32 conversions, tanh-GELU, LayerNorm, the Philox4x32-10 Gumbel noise,
// the sampling of one row of logits, and decode_step, the one-token step
// body that decode_generate and decode_segment both run. All kernels draw the
// same bits from one definition, so the speculative and segmented kernels'
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

// Split-K partial sums of gemv: at most kThreads threads x 8 columns each.
constexpr int kPartial = kThreads * 8;

// y[j] = sum_i x[i] * w[i, j] for a row-major (K, N) weight, N a multiple of
// Vec<T>::N. x lives in shared memory (already rounded to T). Each thread
// owns Vec<T>::N adjacent columns and a slice of K; the slices' partial sums
// are added in a fixed order.
template <typename T>
__device__ void gemv(const float* x, const T* __restrict__ w, int K, int N, float* y,
                     float* partial) {
  constexpr int VN = Vec<T>::N;
  const int tid = threadIdx.x, groups = N / VN;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  for (int t = tid; t < splits * groups; t += kThreads) {
    const int g = t % groups, part = t / groups;
    const int k0 = part * K / splits, k1 = (part + 1) * K / splits;
    float acc[VN] = {};
    const T* col = w + g * VN;
#pragma unroll 8
    for (int i = k0; i < k1; ++i) {
      float v[VN];
      Vec<T>::load(col + (size_t)i * N, v);
#pragma unroll
      for (int c = 0; c < VN; ++c) acc[c] = fmaf(x[i], v[c], acc[c]);
    }
    float* out = splits == 1 ? y : partial + part * N;
#pragma unroll
    for (int c = 0; c < VN; ++c) out[g * VN + c] = acc[c];
  }
  __syncthreads();
  if (splits == 1) return;
  for (int j = tid; j < N; j += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < splits; ++p) acc += partial[p * N + j];
    y[j] = acc;
  }
  __syncthreads();
}

// The packed weights (ops/decode_kernel.py::pack_weights) and the model's
// widths, as decode_step reads them.
template <typename T>
struct Model {
  const T* wte;        // (Vpad, E)
  const T* wte_t;      // (E, Vpad), ln_f scale folded in
  const T* wpe;        // (W, E)
  const float* ln1;    // (L, 2, E)
  const T* qkv_w;      // (L, E, 3E)
  const float* qkv_b;  // (L, 3E)
  const T* proj_w;     // (L, E, E)
  const float* proj_b; // (L, E)
  const T* fc_w;       // (L, E, 4E), ln_2 scale folded in
  const float* fc_b;   // (L, 4E)
  const T* fp_w;       // (L, 4E, E)
  const float* fp_b;   // (L, E)
  const float* logits_b;  // (Vpad,): ln_f beta, NEG_INF on padding lanes
  const T* rel;        // (L, W, E) relative table in cache-row layout
  int layers, heads, head_dim, embed, window, vocab_pad, use_rel;
  float softmax_scale, eps;
};

// Floats of shared scratch that decode_step uses for a score row of `keys`
// slots per head; kernel_smem_bytes() in ops/decode_kernel_batched.py
// mirrors it.
__host__ __device__ inline size_t step_smem_floats(int E, int H, int keys, int V) {
  return 64 + 11 * (size_t)E + 4 * (size_t)V + (size_t)H * keys + kPartial;
}

// The scratch buffers of decode_step, carved out of a block's dynamic
// shared memory in step_smem_floats()'s layout.
struct StepScratch {
  float* red;      // 64 floats (also 16 doubles)
  float* h;        // residual stream
  float* x1;       // ln_1 output
  float* xw;       // matmul operand rounded to T
  float* act;
  float* qkv;      // 3E
  float* hid;      // 4E
  float* logits;   // V
  float* scaled;   // V
  float* scored;   // V
  float* expv;     // V
  float* scores;   // H * keys
  float* partial;  // kPartial
  int keys;        // score row stride: the most slots a step attends to

  __device__ StepScratch(float* smem, int E, int H, int keys_, int V) : keys(keys_) {
    red = smem;
    h = red + 64;
    x1 = h + E;
    xw = x1 + E;
    act = xw + E;
    qkv = act + E;
    hid = qkv + 3 * E;
    logits = hid + 4 * E;
    scaled = logits + V;
    scored = scaled + V;
    expv = scored + V;
    scores = expv + V;
    partial = scores + H * keys;
  }
};

// One token of one sequence through the model, then its sample: embedding
// (wte[token] + wpe[min(pos, W-1)]), the pre-LN layers with the KV append
// and attention over cache slots [0, key_pos] (with the relative bias of
// distance key_pos - j), tied logits, then sample_row with Philox counter
// (step, row). The K/V of this token go to slot key_pos of krows / vrows
// (the sequence's rows of layer 0; layer l's are layer_stride elements on)
// when `write`; otherwise nothing is written. logits_out, when not null,
// receives the logits. Every thread returns the same token.
//
// m and sc are taken by value: with references to the kernel's parameter
// struct, ptxas held the bf16 kernels at 64 registers, and decode_generate
// took 1.38x (B=8) and 1.17x (B=1) the time it takes by value (PERF.md).
template <typename T>
__device__ __forceinline__ int decode_step(const Model<T> m, const StepScratch sc, int token,
                                           int pos, int key_pos, bool write, T* krows0,
                                           T* vrows0, size_t layer_stride, float temp,
                                           float topk, float topp, unsigned seed,
                                           unsigned step, unsigned row, float* logits_out) {
  const int E = m.embed, H = m.heads, D = m.head_dim, V = m.vocab_pad, Wn = m.window;
  const int C = sc.keys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* const red = sc.red;
  float* const h = sc.h;
  float* const x1 = sc.x1;
  float* const xw = sc.xw;
  float* const act = sc.act;
  float* const qkv = sc.qkv;
  float* const hid = sc.hid;
  float* const logits = sc.logits;
  float* const scores = sc.scores;
  float* const partial = sc.partial;

  const int prow = pos < Wn - 1 ? pos : Wn - 1;
  for (int e = tid; e < E; e += kThreads)
    h[e] = to_f(m.wte[(size_t)token * E + e]) + to_f(m.wpe[(size_t)prow * E + e]);
  __syncthreads();

  for (int layer = 0; layer < m.layers; ++layer) {
    const float* ln1 = m.ln1 + (size_t)layer * 2 * E;
    layer_norm<T>(h, x1, xw, E, m.eps, ln1, ln1 + E, red);

    gemv<T>(xw, m.qkv_w + (size_t)layer * E * 3 * E, E, 3 * E, qkv, partial);
    const float* qkv_b = m.qkv_b + (size_t)layer * 3 * E;
    T* krows = krows0 + layer * layer_stride;
    T* vrows = vrows0 + layer * layer_stride;
    for (int e = tid; e < 3 * E; e += kThreads) {
      const float v = qkv[e] + qkv_b[e];
      if (e < E) xw[e] = round_to<T>(v);  // q in the KV type
      else if (!write) continue;
      else if (e < 2 * E) krows[(size_t)key_pos * E + (e - E)] = from_f<T>(v);
      else vrows[(size_t)key_pos * E + (e - 2 * E)] = from_f<T>(v);
    }
    __syncthreads();

    // Scores for slots [0, key_pos]: one (head, slot) pair per thread, slots
    // of one head on adjacent threads.
    const int n = key_pos + 1;
    const T* rel = m.rel + (size_t)layer * Wn * E;
#pragma unroll 4
    for (int idx = tid; idx < H * n; idx += kThreads) {
      const int hh = idx / n, j = idx - hh * n;
      const float* qh = xw + hh * D;
      float acc = head_dot<T>(qh, krows + (size_t)j * E + hh * D, D);
      if (m.use_rel) {
        // Slot j is at distance key_pos - j: E row window-1-(key_pos-j);
        // rows outside the table give no bias. Added before scaling.
        const int r = Wn - 1 - (key_pos - j);
        if (r >= 0) acc += head_dot<T>(qh, rel + (size_t)r * E + hh * D, D);
      }
      scores[hh * C + j] = acc * m.softmax_scale;
    }
    __syncthreads();

    // Softmax per head, one warp per head; weights rounded to T.
    for (int hh = warp; hh < H; hh += kWarps) {
      float* srow = scores + hh * C;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(srow[j] - mx);
        srow[j] = p;
        sum += p;
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < n; j += 32) srow[j] = round_to<T>(srow[j] / sum);
    }
    __syncthreads();

    // attn[e] = sum_j w[head(e), j] * V[j, e]: each thread owns Vec<T>::N
    // adjacent lanes (one head) and a slice of the slots.
    {
      constexpr int VN = Vec<T>::N;
      const int groups = E / VN;
      const int splits = groups >= kThreads ? 1 : kThreads / groups;
      for (int t = tid; t < splits * groups; t += kThreads) {
        const int g = t % groups, part = t / groups;
        const int j0 = part * n / splits, j1 = (part + 1) * n / splits;
        const float* w = scores + (g * VN / D) * C;
        float acc[VN] = {};
#pragma unroll 8
        for (int j = j0; j < j1; ++j) {
          float v[VN];
          Vec<T>::load(vrows + (size_t)j * E + g * VN, v);
#pragma unroll
          for (int c = 0; c < VN; ++c) acc[c] = fmaf(w[j], v[c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < VN; ++c) {
          if (splits == 1) xw[g * VN + c] = round_to<T>(acc[c]);
          else partial[part * E + g * VN + c] = acc[c];
        }
      }
      __syncthreads();
      if (splits > 1) {
        for (int e = tid; e < E; e += kThreads) {
          float acc = 0.f;
          for (int p = 0; p < splits; ++p) acc += partial[p * E + e];
          xw[e] = round_to<T>(acc);
        }
        __syncthreads();
      }
    }

    gemv<T>(xw, m.proj_w + (size_t)layer * E * E, E, E, act, partial);
    const float* proj_b = m.proj_b + (size_t)layer * E;
    for (int e = tid; e < E; e += kThreads) h[e] = x1[e] + (act[e] + proj_b[e]);  // x2
    __syncthreads();

    layer_norm<T>(h, nullptr, xw, E, m.eps, nullptr, nullptr, red);
    gemv<T>(xw, m.fc_w + (size_t)layer * E * 4 * E, E, 4 * E, hid, partial);
    const float* fc_b = m.fc_b + (size_t)layer * 4 * E;
    for (int j = tid; j < 4 * E; j += kThreads) {
      const float x = hid[j] + fc_b[j];
      hid[j] = round_to<T>(gelu_tanh(x));
    }
    __syncthreads();
    gemv<T>(hid, m.fp_w + (size_t)layer * 4 * E * E, 4 * E, E, act, partial);
    const float* fp_b = m.fp_b + (size_t)layer * E;
    for (int e = tid; e < E; e += kThreads) h[e] = (h[e] + act[e]) + fp_b[e];
    __syncthreads();
  }

  // Tied logits: standardize(h) @ wte_t + logits_b.
  layer_norm<T>(h, nullptr, xw, E, m.eps, nullptr, nullptr, red);
  gemv<T>(xw, m.wte_t, E, V, logits, partial);
  for (int v = tid; v < V; v += kThreads) {
    logits[v] += m.logits_b[v];
    if (logits_out != nullptr) logits_out[v] = logits[v];
  }
  __syncthreads();

  return sample_row(logits, sc.scaled, sc.scored, sc.expv, V, temp, topk, topp, seed, step, row,
                    red);
}

}  // namespace decode_common
