// Device code shared by the two streamed-weight decode kernels,
// decode_wide.cu (one whole generation) and decode_wide_segment.cu (segments
// of a continuous batch): the 16-byte weight and activation loads, the copy of
// rows written inside the launch, the LayerNorm of B rows, the matmul phase
// that reads each weight once for all rows, the merge of the attention's key
// splits, and the scratch and shared-memory layouts.
// Both kernels run one persistent kThreads-thread block per SM, launched
// cooperatively, with grid barriers between the phases of a layer.

#pragma once

#include "decode_common.cuh"

namespace decode_wide_common {

using namespace decode_common;

constexpr int kMaxBatch = 8;    // MAX_BATCH in ops/decode_kernel_wide.py
constexpr int kMaxSplits = 16;  // MAX_SPLITS

// A weight type's 16-byte load (VN elements) and the columns (NC) one warp
// computes together, so that each x value read from shared memory feeds NC
// products.
template <typename W> struct WLoad;
template <> struct WLoad<float> {
  static constexpr int VN = 4, NC = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    Vec<float>::load(p, out);
  }
};
template <> struct WLoad<__nv_bfloat16> {
  static constexpr int VN = 8, NC = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    Vec<__nv_bfloat16>::load(p, out);
  }
};
template <> struct WLoad<int8_t> {
  static constexpr int VN = 16, NC = 2;
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) out[4 * w + i] = (float)((int)(words[w] << (24 - 8 * i)) >> 24);
  }
};

// N consecutive elements as floats: ld.global.cg (L2) for data written in
// this launch, plain loads for read-only tables.
template <typename T, int N> struct Load;
template <> struct Load<float, 4> {
  static __device__ __forceinline__ void cg(const float* p, float* out) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void ro(const float* p, float* out) {
    Vec<float>::load(p, out);
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void cg(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pairs[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void ro(const __nv_bfloat16* p, float* out) {
    Vec<__nv_bfloat16>::load(p, out);
  }
};
template <> struct Load<int8_t, 4> {
  static __device__ __forceinline__ void cg(const int8_t* p, float* out) {
    const char4 v = __ldcg(reinterpret_cast<const char4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Load<int8_t, 8> {
  static __device__ __forceinline__ void cg(const int8_t* p, float* out) {
    const int2 v = __ldcg(reinterpret_cast<const int2*>(p));
    const char4 lo = *reinterpret_cast<const char4*>(&v.x);
    const char4 hi = *reinterpret_cast<const char4*>(&v.y);
    out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
    out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
  }
};

// dst[0, n) = src[0, n) from data written in this launch, n a multiple of 4:
// 16-byte loads, several in flight per thread.
__device__ __forceinline__ void copy_cg(float* dst, const float* src, int n) {
#pragma unroll 4
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
    *reinterpret_cast<float4*>(dst + i) = __ldcg(reinterpret_cast<const float4*>(src + i));
}

// LayerNorm of B rows of E floats in shared memory, over the whole block:
// each row gets kWarps / B' warps (B' = B rounded up to a power of two), so
// at B = 1 all 16 warps share the row. y = (x - mean) * rsqrt(var + eps)
// [* scale + bias]; out (may be null) receives y, xw y rounded to A.
template <typename A>
__device__ void rows_layer_norm(const float* x, float* out, float* xw, int B, int E, float eps,
                                const float* scale, const float* bias, float* red) {
  int rows = 1;
  while (rows < B) rows *= 2;
  const int per_row = kWarps / rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / per_row, first = (warp % per_row) * 32 + lane, stride = per_row * 32;
  const float* xr = x + (size_t)r * E;
  float s = 0.f;
  if (r < B)
    for (int e = first; e < E; e += stride) s += xr[e];
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float mean = 0.f;
  for (int i = 0; i < per_row && r < B; ++i) mean += red[r * per_row + i];
  mean /= E;
  float q = 0.f;
  if (r < B)
    for (int e = first; e < E; e += stride) {
      const float c = xr[e] - mean;
      q += c * c;
    }
  for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  __syncthreads();
  if (lane == 0) red[warp] = q;
  __syncthreads();
  float var = 0.f;
  for (int i = 0; i < per_row && r < B; ++i) var += red[r * per_row + i];
  const float rs = rsqrtf(var / E + eps);
  if (r < B)
    for (int e = first; e < E; e += stride) {
      float y = (xr[e] - mean) * rs;
      if (scale != nullptr) y = y * scale[e] + bias[e];
      if (out != nullptr) out[(size_t)r * E + e] = y;
      xw[(size_t)r * E + e] = round_to<A>(y);
    }
  __syncthreads();
}

// One matmul phase: y[b, j] = sum_k xs[b*K + k] * w[j*K + k] for the B rows
// and the N output columns of an output-major (N, K) weight; epi(b, j, y) is
// called once for each. Column groups of NC go to G warps each (G warps split
// K), G as large as the grid's warps allow; a block takes kWarps / G groups
// per round. Partial sums are combined in a fixed order. Every thread of every
// block must call it (it synchronises the block).
template <typename W, typename Epi>
__device__ void gemv_phase(const float* xs, const W* __restrict__ w, int K, int N, int B,
                           float* gred, Epi epi) {
  constexpr int VN = WLoad<W>::VN, NC = WLoad<W>::NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = N / NC;
  const int chunk = 32 * VN;
  const int chunks = (K + chunk - 1) / chunk;
  const int total_warps = gridDim.x * kWarps;
  int G = 1;
  while (G < kWarps && 2 * G <= chunks && (long long)groups * 2 * G <= total_warps) G *= 2;
  const int per_block = kWarps / G;
  const int slot = warp / G, member = warp % G;
  const int rounds = (groups + per_block * gridDim.x - 1) / (per_block * gridDim.x);
  for (int round = 0; round < rounds; ++round) {
    const int first = (round * gridDim.x + blockIdx.x) * per_block;
    const int group = first + slot;
    float acc[NC][kMaxBatch];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) acc[c][b] = 0.f;
    if (group < groups) {
      const W* wg = w + (size_t)group * NC * K;
      for (int ci = member; ci < chunks; ci += G) {
        const int k = ci * chunk + lane * VN;
        if (k >= K) continue;
        float wv[NC][VN];
#pragma unroll
        for (int c = 0; c < NC; ++c) WLoad<W>::load(wg + (size_t)c * K + k, wv[c]);
#pragma unroll
        for (int b = 0; b < kMaxBatch; ++b) {
          if (b >= B) break;
          float xv[VN];
#pragma unroll
          for (int i = 0; i < VN; i += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(xs + (size_t)b * K + k + i);
            xv[i] = x4.x; xv[i + 1] = x4.y; xv[i + 2] = x4.z; xv[i + 3] = x4.w;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int i = 0; i < VN; ++i) acc[c][b] = fmaf(xv[i], wv[c][i], acc[c][b]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= B) break;
        float v = acc[c][b];
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) gred[(warp * NC + c) * kMaxBatch + b] = v;
      }
    __syncthreads();
    for (int t = threadIdx.x; t < per_block * NC * B; t += kThreads) {
      const int s = t / (NC * B), c = (t / B) % NC, b = t % B;
      if (first + s >= groups) continue;
      float sum = 0.f;
      for (int m = 0; m < G; ++m) sum += gred[((s * G + m) * NC + c) * kMaxBatch + b];
      epi(b, (first + s) * NC + c, sum);
    }
    __syncthreads();
  }
}

// The first half of the proj phase: each (row, head)'s key splits, the
// partials (acc[D], max, sum) of part (B, H, kMaxSplits, D + 2), merged into
// xs[b*E + head*D + d] rounded to A. splits(b) is row b's split count; every
// row has at least one split that is not empty. wts holds B*H*(kMaxSplits+1)
// floats of shared scratch. Each (row, head) first gets its splits' weights
// exp(m_s - max) and their sum of l_s, then every lane its weighted sum of
// the partial accs. Every thread of the block calls it.
template <typename A, typename Splits>
__device__ __forceinline__ void merge_splits(const float* part, float* xs, float* wts, int B,
                                             int H, int D, int E, Splits splits) {
  for (int i = threadIdx.x; i < B * H; i += kThreads) {
    const int S = splits(i / H);
    const float* p = part + (size_t)i * kMaxSplits * (D + 2);
    float m = -CUDART_INF_F;
    for (int s = 0; s < S; ++s) m = fmaxf(m, __ldcg(p + s * (D + 2) + D));
    float den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(__ldcg(p + s * (D + 2) + D) - m);
      wts[i * (kMaxSplits + 1) + s] = w;
      den += __ldcg(p + s * (D + 2) + D + 1) * w;
    }
    wts[i * (kMaxSplits + 1) + kMaxSplits] = den;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < B * E; i += kThreads) {
    const int b = i / E, e = i - b * E, hh = e / D, d = e - hh * D;
    const int S = splits(b);
    const float* p = part + ((size_t)b * H + hh) * kMaxSplits * (D + 2) + d;
    const float* w = wts + (b * H + hh) * (kMaxSplits + 1);
    float num = 0.f;
    for (int s = 0; s < S; ++s) num += __ldcg(p + s * (D + 2)) * w[s];
    xs[i] = round_to<A>(num / w[kMaxSplits]);
  }
  __syncthreads();
}

// The float32 scratch of a launch, in this order: x1, q, x2 and h (B x E
// each), the MLP hidden (B x 4E), the logits (B x V), the attention
// partials (B x H x kMaxSplits x (D + 2)) and the B input tokens.
// _scratch_floats in ops/decode_kernel_wide.py mirrors it.
__host__ __device__ inline size_t scratch_floats(int B, int E, int H, int D, int V) {
  return 8 * (size_t)B * E + (size_t)B * V + (size_t)B * H * kMaxSplits * (D + 2) + B;
}

// Dynamic shared memory of one block, in floats, for B rows and attention
// splits of at most C keys: reductions, the B x kMaxBatch partial sums of
// every warp's 4 columns, the rows' B x E inputs and a union of the matmul
// operand (B x 4E), one attention split (q, C scores, 8 partial sums a
// thread) and the sampler's 4 rows of V. wide_smem_bytes() in
// ops/decode_kernel_wide.py mirrors it.
__host__ __device__ inline size_t smem_floats(int B, int E, int D, int C, int V) {
  size_t u = (size_t)B * 4 * E;
  const size_t attn = (size_t)D + C + (size_t)kThreads * 8;
  if (attn > u) u = attn;
  if ((size_t)4 * V > u) u = (size_t)4 * V;
  return 64 + kWarps * 4 * kMaxBatch + (size_t)B * E + u;
}

}  // namespace decode_wide_common
