// flash_attention: causal attention with the Music-Transformer relative bias
// and in-kernel dropout, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels composer_tpu/ops/pallas_attention.py
// _flash_kernel (forward) and _flash_bwd_kernel (merged backward). Same
// contract as the plain PyTorch versions in
// composer_tpu_torch/ops/flash_attention.py (flash_attention_reference,
// flash_attention_backward_reference).
//
// Layout: q, k, v, out, dout, dk, dv are [BH, S, D] in T (float or bf16);
// the relative table E is [H, W, D] in T, E[h, W-1-d] holding distance d;
// lse and delta = rowsum(dout * out) are [BH, S] float32; dq [BH, S, D] and
// dE [H, W, D] are float32 sums that the caller zeroes and casts back.
//
//   score(i, j) = (q_i . k_j + q_i . E[h, W-1-(i-j)]) * scale,  j <= i
//   p(i, j)     = exp(score - lse_i),  lse_i = log sum_j exp(score(i, j))
//   out_i       = sum_j p(i, j) * M(i, j) * v_j
//
// The bias is added before the scale, as in _tile_scores. Keys after the
// query get -1e30 (probability exactly 0). M is the dropout multiplier:
// keep_scale = 1/(1-rate) where the 32-bit Philox4x32-10 word for (q
// position, k position) is >= threshold = rate * 2^32, else 0. The word is
// word (k & 3) of Philox with counter (k >> 2, q, bh, 0) and key (seed, 0),
// one per element, so the backward regenerates the forward's mask whatever
// its tiling; the row normaliser l comes from the undropped p.
//
// Two pairs of kernels, one per route (ops/flash_attention.py::kernel_variant),
// each built at head_dim 16, 32, 64 and 128 (the wrapper zero-pads any
// other head_dim up to 128 to the next of these, as the JAX wrapper pads to
// 128 lanes, with the scale of the true depth):
//
// * bf16: the tensor-core kernels of
//   flash_attention_mma.cuh (flash_forward_mma_kernel, replacing
//   _flash_kernel; flash_backward_mma_kernel, replacing _flash_bwd_kernel).
//   Every product is mma.sync.m16n8k16 (bf16 in, float32 sums): QK^T, PV,
//   the relative band, and the backward's. What bounds them on this card is
//   not the tensor cores (chip_smoke.py's flash_bound is several times
//   below their time; PERF.md) but the work around each score and the
//   shared-memory and atomic traffic: at head_dim 16 a score takes 2 x 16 operations of QK^T
//   and PV against one exp2, a mask test and, with dropout, a quarter of a
//   10-round Philox call; the band adds a product and a skewed read. The
//   design keeps that work small and off the critical path:
//   - 4 warps of 16 rows a block; Q fragments in registers; tiles staged
//     with cp.async (the forward's K, V and E double-buffered) at a padded
//     pitch, so ldmatrix is free of bank conflicts; P goes from the S accumulators to the PV
//     operands in registers;
//   - exp2 with the scale and log2(e) folded into one multiply;
//   - dropout: one Philox call (4 words) a lane per 8-key tile, its words
//     handed to the lanes that need them through a per-warp shared buffer (selects and
//     shuffles cost more than the Philox rounds);
//   - the relative band as a product: a warp's 16 rows reach 80 band rows,
//     so q.E is one 16 x 80 product, staged in the warp's shared memory and
//     read back skewed (the Music Transformer's skew), with no block barrier
//     in the forward;
//   - shared memory sized by the bias, so that more blocks fit an SM without
//     it (at D=128 with the bias, about 162 KB: one block an SM).
//   The backward recomputes P from lse (FlashAttention-2 order, one 64-key
//   tile a block, 16 keys a warp), keeps dK and dV in registers, stages dS^T
//   in shared memory as bf16 and forms dq = c (dS K + Bm E_band) from it (Bm
//   the skewed dS), sent with 4-float atomics. dE_band = c Bm^T Q: each warp
//   keeps the 16 band rows it owns in registers; a q-tile's low rows are
//   the next q-tile's high rows of the same warp, so each dE row leaves
//   once, as 4-float atomics, when no later q-tile reaches it. At D=128 the
//   accumulators of dK, dV, dE and dq (4 x 64 floats a thread) exceed the
//   255 registers, so two warps share a key group, each owning half of the
//   columns (bwd_split; 8 warps a block).
// * float32: the scalar kernels below (flash_forward_kernel,
//   flash_backward_kernel; the f32 parity tests and f32 training). A row of
//   a 64-row tile is split over D/16 neighbouring threads of a warp, 16
//   columns each (flash_row_threads; one thread at D=16), which sum their
//   partial dot products with shuffles: the registers a thread holds do not
//   grow with D. float32 FMAs on tiles staged in shared memory (rows padded
//   to D+4 floats so that the per-thread rows of the relative band are read
//   as conflict-free 16-byte loads); bound by issue rate, far above the
//   card's memory bound (see PERF.md).
//   - Forward, grid (S/64, BH): the threads of row i keep their slice of
//     q_i and of the output row, and the running max and sum, in registers
//     and walk the k-tiles at or before the diagonal (online softmax). The
//     relative band a tile needs is 128 rows of E, staged beside the K and
//     V tiles; element (i, j) reads band row 63-i+j.
//   - Backward, grid (S/64, BH), FlashAttention-2 order: the threads of key
//     j own its slices of k, v, dK and dV in registers and walk the q-tiles
//     at or after the diagonal, recomputing p from lse. ds goes to shared
//     memory; then the threads of query row i form their slice of its dq row
//     and add it to dq with float32 atomics, and those of band rows m and
//     m + 64 their slices of dE: the hi row leaves with atomics (no later
//     q-tile reaches it), the lo row is carried in registers, since it is
//     the same E row as the next q-tile's hi row m + 64.
//   At D=128 the shared memory of the backward is about 182 KB.
//
// Blocks of different (b, k-tile) share dq and dE rows, which the TPU
// accumulated in place only because its grid ran in order; the atomics make
// the summation order vary between runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry points: flash_attention_forward(...), flash_attention_backward(...);
// each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;          // rows per tile (scalar kernels: one thread per row)
constexpr int kBand = 2 * kBlock;   // relative-table rows one tile can need
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* e;       // [H, W, D] or null
  const void* dout;    // backward only
  void* out;           // forward only
  float* lse;          // [BH, S]
  const float* delta;  // [BH, S], backward only
  const int* seed;     // one int32 on the device, read when dropout is on
  float* dq;           // [BH, S, D] float32 sums, backward only
  void* dk;
  void* dv;
  float* de;           // [H, W, D] float32 sums, backward with the bias only
  int bh, heads, seq, window, use_rel, dropout;
  float scale, keep_scale;
  unsigned threshold;
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

__device__ __forceinline__ unsigned word(const uint4& r, int c) {
  return c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w;
}

// Dropout multiplier of element (qpos, kpos) of row block bh.
__device__ __forceinline__ float keep_multiplier(const Args& a, unsigned seed, int bh,
                                                 int qpos, int kpos) {
  const uint4 r = philox4x32_10(make_uint4((unsigned)kpos >> 2, (unsigned)qpos,
                                           (unsigned)bh, 0u), make_uint2(seed, 0u));
  return word(r, kpos & 3) >= a.threshold ? a.keep_scale : 0.f;
}

// The float32 kernels split each row's D columns over L = D / kSlice
// neighbouring threads of a warp, kSlice columns each (flash_row_threads).
constexpr int kSlice = 16;

template <int D>
__host__ __device__ constexpr int flash_row_threads() {
  return D / kSlice;
}

// The sum of x over the L neighbouring lanes that share a row.
template <int L>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot_reg(const float (&x)[kSlice], const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kSlice; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + d);
    acc = fmaf(x[d], y.x, acc);
    acc = fmaf(x[d + 1], y.y, acc);
    acc = fmaf(x[d + 2], y.z, acc);
    acc = fmaf(x[d + 3], y.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_smem(const float* x, const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kSlice; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + d);
    const float4 b = *reinterpret_cast<const float4*>(row + d);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy(float (&acc)[kSlice], float w, const float* row) {
#pragma unroll
  for (int d = 0; d < kSlice; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(w, y.x, acc[d]);
    acc[d + 1] = fmaf(w, y.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, y.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, y.w, acc[d + 3]);
  }
}

// rows x D floats from global (row-major, contiguous) into shared
// memory as float32 rows of pitch D+4.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int rows) {
  constexpr int P = D + 4;
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    dst[(idx / D) * P + idx % D] = src[idx];
  }
}

// The 128 band rows E[first .. first+127] of one head (zeros outside [0, W)).
template <int D>
__device__ __forceinline__ void load_band(float* dst, const float* e_head, int first, int window) {
  constexpr int P = D + 4;
  for (int idx = threadIdx.x; idx < kBand * D; idx += blockDim.x) {
    const int row = first + idx / D;
    dst[(idx / D) * P + idx % D] =
        (row >= 0 && row < window) ? e_head[(size_t)row * D + idx % D] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash_row_threads<D>()) flash_forward_kernel(const Args a) {
  constexpr int P = D + 4, L = flash_row_threads<D>();
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * P;
  float* es = vs + kBlock * P;

  const int nb = a.seq / kBlock;
  const int ib = nb - 1 - (int)blockIdx.x;  // the longest rows start first
  const int bh = blockIdx.y, h = bh % a.heads;
  // Row i of the tile, columns [col, col + kSlice) of it.
  const int i = threadIdx.x / L, col = (threadIdx.x % L) * kSlice, qpos = ib * kBlock + i;
  const size_t base = (size_t)bh * a.seq * D;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* e_head =
      a.use_rel ? static_cast<const float*>(a.e) + (size_t)h * a.window * D : nullptr;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;

  float qr[kSlice], acc[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    qr[d] = q[(size_t)qpos * D + col + d];
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int jb = 0; jb <= ib; ++jb) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, k + (size_t)jb * kBlock * D, kBlock);
    load_tile<D>(vs, v + (size_t)jb * kBlock * D, kBlock);
    if (a.use_rel) load_band<D>(es, e_head, a.window - kBlock - (ib - jb) * kBlock, a.window);
    __syncthreads();

    float s[kBlock];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      float x = dot_reg(qr, ks + j * P + col);
      if (a.use_rel) x += dot_reg(qr, es + (kBlock - 1 - i + j) * P + col);
      x = row_sum<L>(x) * a.scale;
      if (jb == ib && j > i) x = kNegInf;
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m, tile_max);
    const float correction = expf(m - m_new);
    l *= correction;
#pragma unroll
    for (int d = 0; d < kSlice; ++d) acc[d] *= correction;
#pragma unroll
    for (int j0 = 0; j0 < kBlock; j0 += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (a.dropout) {
        bits = philox4x32_10(make_uint4((unsigned)(jb * kBlock + j0) >> 2, (unsigned)qpos,
                                        (unsigned)bh, 0u), make_uint2(seed, 0u));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = expf(s[j0 + c] - m_new);
        l += p;
        if (a.dropout) p *= word(bits, c) >= a.threshold ? a.keep_scale : 0.f;
        axpy(acc, p, vs + (j0 + c) * P + col);
      }
    }
    m = m_new;
  }

  float* out = static_cast<float*>(a.out) + base + (size_t)qpos * D + col;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int d = 0; d < kSlice; ++d) out[d] = acc[d] * inv_l;
  if (col == 0) a.lse[(size_t)bh * a.seq + qpos] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash_row_threads<D>()) flash_backward_kernel(const Args a) {
  constexpr int P = D + 4, L = flash_row_threads<D>();
  constexpr int DS = kBlock + 1;  // ds pitch: row and column reads conflict-free
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * P;
  float* ks = dos + kBlock * P;
  float* es = ks + kBlock * P;
  float* ds = es + kBand * P;
  float* lse_s = ds + kBlock * DS;
  float* delta_s = lse_s + kBlock;

  const int nb = a.seq / kBlock;
  const int jb = blockIdx.x;  // the longest columns start first
  const int bh = blockIdx.y, h = bh % a.heads;
  // Row r of the tile (key r in phase 1, query r in phase 2, band rows r and
  // r + 64 in phase 3), columns [col, col + kSlice) of it.
  const int tid = threadIdx.x, r = tid / L, col = (tid % L) * kSlice, kpos = jb * kBlock + r;
  const int W = a.window;
  const size_t base = (size_t)bh * a.seq * D;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;
  const float* e_head = a.use_rel ? static_cast<const float*>(a.e) + (size_t)h * W * D : nullptr;
  float* de_head = a.use_rel ? a.de + (size_t)h * W * D : nullptr;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;

  // carry: dE of band row r of the lo half (E row W - 64 - 64t + r), which
  // is band row r + 64 of the hi half of the next q-tile.
  float kr[kSlice], vr[kSlice], dk[kSlice], dv[kSlice], carry[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    kr[d] = k[(size_t)kpos * D + col + d];
    vr[d] = v[(size_t)kpos * D + col + d];
    dk[d] = 0.f;
    dv[d] = 0.f;
    carry[d] = 0.f;
  }
  load_tile<D>(ks, k + (size_t)jb * kBlock * D, kBlock);

  for (int ib = jb; ib < nb; ++ib) {
    const int t = ib - jb;
    __syncthreads();  // the previous q-tile is consumed
    load_tile<D>(qs, q + (size_t)ib * kBlock * D, kBlock);
    load_tile<D>(dos, dout + (size_t)ib * kBlock * D, kBlock);
    if (tid < kBlock) {
      lse_s[tid] = a.lse[(size_t)bh * a.seq + ib * kBlock + tid];
      delta_s[tid] = a.delta[(size_t)bh * a.seq + ib * kBlock + tid];
    }
    if (a.use_rel) load_band<D>(es, e_head, W - kBlock - t * kBlock, W);
    __syncthreads();

    // Phase 1, row = key: p, ds, and this key's dK and dV.
    for (int i = 0; i < kBlock; ++i) {
      const float* qrow = qs + i * P + col;
      const float* dorow = dos + i * P + col;
      float x = dot_reg(kr, qrow);
      if (a.use_rel) x += dot_smem(qrow, es + (kBlock - 1 - i + r) * P + col);
      x = row_sum<L>(x) * a.scale;
      const float p = (t == 0 && r > i) ? 0.f : expf(x - lse_s[i]);
      float dp = row_sum<L>(dot_reg(vr, dorow));
      float p_dv = p;
      if (a.dropout) {
        const float mult = keep_multiplier(a, seed, bh, ib * kBlock + i, kpos);
        dp *= mult;
        p_dv = p * mult;
      }
      const float dsv = p * (dp - delta_s[i]);
      axpy(dv, p_dv, dorow);
      axpy(dk, dsv, qrow);
      if (col == 0) ds[i * DS + r] = dsv;
    }
    __syncthreads();

    // Phase 2, row = query: dq_r = scale * sum_j ds_rj (k_j + E_band[63-r+j]).
    {
      float g[kSlice];
#pragma unroll
      for (int d = 0; d < kSlice; ++d) g[d] = 0.f;
      for (int j = 0; j < kBlock; ++j) {
        const float w = ds[r * DS + j];
        axpy(g, w, ks + j * P + col);
        if (a.use_rel) axpy(g, w, es + (kBlock - 1 - r + j) * P + col);
      }
      float* dq_row = a.dq + base + (size_t)(ib * kBlock + r) * D + col;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) atomicAdd(dq_row + d, a.scale * g[d]);
    }
    if (a.use_rel) {
      // Band row m = 63-i+j collects scale * sum ds_ij q_i. Rows m >= 64
      // ("hi", E rows W - 64t + m - 64) are complete after this q-tile: the
      // hi row r + 64 plus the carried lo row r of the previous tile leaves
      // now. Rows m < 64 ("lo", E rows W - 64 - 64t + m) are carried on.
#pragma unroll
      for (int half = 1; half >= 0; --half) {
        const int mm = r + half * kBlock;
        float g[kSlice];
#pragma unroll
        for (int d = 0; d < kSlice; ++d) g[d] = 0.f;
        const int i0 = max(0, kBlock - 1 - mm), i1 = min(kBlock - 1, 2 * kBlock - 2 - mm);
        for (int i = i0; i <= i1; ++i) axpy(g, ds[i * DS + mm - (kBlock - 1) + i], qs + i * P + col);
        if (half) {
          const int row = W - t * kBlock + r;  // none for the diagonal tile
          if (row < W) {
            float* dst = de_head + (size_t)row * D + col;
#pragma unroll
            for (int d = 0; d < kSlice; ++d) atomicAdd(dst + d, fmaf(a.scale, g[d], carry[d]));
          }
        } else {
#pragma unroll
          for (int d = 0; d < kSlice; ++d) carry[d] = a.scale * g[d];
        }
      }
    }
  }
  if (a.use_rel) {
    const int row = W - kBlock - (nb - 1 - jb) * kBlock + r;
    if (row >= 0 && row < W) {
      float* dst = de_head + (size_t)row * D + col;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) atomicAdd(dst + d, carry[d]);
    }
  }

  float* dk_out = static_cast<float*>(a.dk) + base + (size_t)kpos * D + col;
  float* dv_out = static_cast<float*>(a.dv) + base + (size_t)kpos * D + col;
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    dk_out[d] = a.scale * dk[d];
    dv_out[d] = dv[d];
  }
}

template <int D> constexpr size_t forward_smem() {
  return sizeof(float) * (size_t)(2 * kBlock + kBand) * (D + 4);
}
template <int D> constexpr size_t backward_smem() {
  return sizeof(float) * ((size_t)(3 * kBlock + kBand) * (D + 4) + kBlock * (kBlock + 1) +
                          2 * kBlock);
}

// The bf16 tensor-core kernels; they share Args, the constants and Philox
// with the scalar kernels above.
#include "flash_attention_mma.cuh"

template <typename K>
int launch(K kernel, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > (size_t)kMaxSharedBytes || a.seq % kBlock != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.seq / kBlock, a.bh), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instances built, one per (route, head_dim) of
// ops/flash_attention.py::VARIANTS (head_dim 16, 32, 64 and 128 on each
// route; the wrapper pads any other head_dim up to the next of them); any
// other head_dim is refused.
template <int D>
int forward_at(int mma, const Args& a, cudaStream_t stream) {
  if (mma) {
    return launch(flash_forward_mma_kernel<D>, kMmaThreads, forward_mma_smem<D>(a.use_rel), a,
                  stream);
  }
  return launch(flash_forward_kernel<D>, kBlock * flash_row_threads<D>(), forward_smem<D>(), a,
                stream);
}

template <int D>
int backward_at(int mma, const Args& a, cudaStream_t stream) {
  if (mma) {
    return launch(flash_backward_mma_kernel<D>, bwd_threads<D>(), backward_mma_smem<D>(a.use_rel),
                  a, stream);
  }
  return launch(flash_backward_kernel<D>, kBlock * flash_row_threads<D>(), backward_smem<D>(), a,
                stream);
}

int forward(int mma, int depth, const Args& a, cudaStream_t stream) {
  switch (depth) {
    case 16: return forward_at<16>(mma, a, stream);
    case 32: return forward_at<32>(mma, a, stream);
    case 64: return forward_at<64>(mma, a, stream);
    case 128: return forward_at<128>(mma, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int backward(int mma, int depth, const Args& a, cudaStream_t stream) {
  switch (depth) {
    case 16: return backward_at<16>(mma, a, stream);
    case 32: return backward_at<32>(mma, a, stream);
    case 64: return backward_at<64>(mma, a, stream);
    case 128: return backward_at<128>(mma, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* e, const void* lse,
               const void* seed, int bh, int heads, int seq, int window, int use_rel,
               float scale, unsigned threshold, float keep_scale, int dropout) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.e = e;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.seed = static_cast<const int*>(seed);
  a.bh = bh;
  a.heads = heads;
  a.seq = seq;
  a.window = window;
  a.use_rel = use_rel;
  a.dropout = dropout;
  a.scale = scale;
  a.keep_scale = keep_scale;
  a.threshold = threshold;
  return a;
}

}  // namespace

extern "C" int flash_attention_forward(
    int mma, int device, const void* q, const void* k, const void* v, const void* e,
    void* out, void* lse, const void* seed, int bh, int heads, int seq, int depth,
    int window, int use_rel, float scale, unsigned threshold, float keep_scale, int dropout,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, e, lse, seed, bh, heads, seq, window, use_rel, scale,
                     threshold, keep_scale, dropout);
  a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return forward(mma, depth, a, s);
}

extern "C" int flash_attention_backward(
    int mma, int device, const void* q, const void* k, const void* v, const void* e,
    const void* dout, const void* lse, const void* delta, const void* seed, void* dq,
    void* dk, void* dv, void* de, int bh, int heads, int seq, int depth, int window,
    int use_rel, float scale, unsigned threshold, float keep_scale, int dropout,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, e, lse, seed, bh, heads, seq, window, use_rel, scale,
                     threshold, keep_scale, dropout);
  a.dout = dout;
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = dk;
  a.dv = dv;
  a.de = static_cast<float*>(de);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward(mma, depth, a, s);
}
