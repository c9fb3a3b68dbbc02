// decode_wide: the whole autoregressive generation of the Music Transformer in
// one kernel launch, for models whose weights outgrow the card's fast memory,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_wide.py (_wide_kernel).
// Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_wide.py::decode_wide_reference.
//
// What bounds it: HBM bytes. At embed 1024 the packed weights are about 200 MB
// of bf16, four times the 50 MB L2, so every step has to stream them from
// HBM, plus each layer's K/V prefix. decode_generate (one block per sequence)
// reads all weights once per block per step at one SM's read rate. Here the
// grid is one persistent block per SM, launched cooperatively, and the step's
// work is cut into phases separated by grid-wide barriers:
//
//   per layer  P1  ln_1 + qkv matmul; k, v to the cache (or the int8 window)
//              P2  attention: (row, head, key split) items over the blocks,
//                  one partial (max, sum, acc) each; int8 K/V rows quantized
//              P3  merge of the partials + attention-proj matmul + residual
//              P4  ln_2 + mlp-fc matmul + GELU
//              P5  mlp-proj matmul + residual
//   per step   P6  ln_f + tied-head matmul; P7 one block per row samples.
//
// In a matmul phase each block owns a slice of output columns (the weights are
// packed output-major, one contiguous row per column) and applies every weight
// it loads to all B rows, whose inputs sit in its shared memory: each weight
// byte is read from HBM once per step, by all SMs at once. The rows'
// activations travel between phases through a small float32 scratch that stays
// in L2; data written inside the launch is read with ld.global.cg (L2, not the
// SMs' incoherent L1).
//
// One cooperative launch rather than per-phase launches captured in a CUDA
// graph (the other form the design allowed): the step's token and the rows'
// activations never leave the card, and a barrier is a flag in L2 rather than
// a kernel boundary. A launch whose grid could not be resident at once would
// hang at its first barrier, so launch() refuses it. Most of a step is the
// phases' own latency chains (loads of the rows, LayerNorm, the matmul's
// first HBM round trip, the partial-sum reduction), not bandwidth: the
// kernel's optional clock (phase_ns in the wrapper) times each phase.
// Tensor-core products for B = 8, wgmma/TMA and fewer phases are later work.
//
// Numerics: matmul inputs are rounded to the activation type A (bf16 for bf16
// and int8 weights), products accumulate in float32, and an int8 weight's
// per-column scale multiplies the sum. q is rounded to A; scores, softmax and
// the AV sum stay float32. Sampling is decode_common.cuh's sample_row, so the
// Philox Gumbel noise equals decode_generate's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: decode_wide(...), returns the launch's cudaError_t.

#include <cooperative_groups.h>

#include "decode_wide_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace decode_common;
using namespace decode_wide_common;

constexpr int kTail = 128;  // TAIL in ops/decode_kernel_wide.py

template <typename W, typename A, bool KVQ>
struct Args {
  const W* big_w;          // (L, 8E, E) output-major: qkv | proj | fc columns
  const W* fp_w;           // (L, E, 4E)
  const float* wscale;     // (L, 8E) int8 column scales, else null
  const float* fpscale;    // (L, E)
  const A* wte;            // (Vpad, E)
  const A* logits_w;       // (Vpad, E), ln_f scale folded in
  const A* wpe;            // (W, E)
  const float* ln1;        // (L, 2, E)
  const float* qkv_b;      // (L, 3E)
  const float* proj_b;     // (L, E)
  const float* fc_b;       // (L, 4E), ln_2 folded in
  const float* fp_b;       // (L, E)
  const float* logits_b;   // (Vpad,), NEG_INF on padding lanes
  const A* rel;            // (L, W, E) relative table in cache-row layout
  A* kv;                   // float K/V: (L, 2, B, C, E)
  int8_t* kq;              // int8 K/V: (L, 2, B, C, E)
  float* ks;               // (L, 2, B, C)
  A* tail;                 // (L, 2, B, kTail, E)
  const int* prompts;      // (B, P)
  const int* plens;        // (B,)
  const float* temps;      // (B,)
  const float* topk;       // (B,), Vpad+1 = off
  const float* topp;       // (B,), 2.0 = off
  int* tokens;             // (B, out_len)
  float* logits_out;       // (B, Vpad) last step's logits, or null
  unsigned long long* clock;  // (kPhases,) ns per phase kind, or null
  // Scratch, in scratch_floats()'s order.
  float* x1;               // (B, E) ln_1 output (the residual's base)
  float* q;                // (B, E) q rounded to A
  float* x2;               // (B, E)
  float* h;                // (B, E) residual stream
  float* hid;              // (B, 4E) GELU output rounded to A
  float* logits;           // (B, Vpad)
  float* part;             // (B, H, kMaxSplits, D + 2): acc[D], max, sum
  int* token;              // (B,) the next input
  int batch, prompt_width, layers, heads, head_dim, embed, cache_len, window, vocab_pad;
  int num_steps, out_len, use_rel, splits;
  unsigned seed;
  float softmax_scale, eps;
};

template <typename W, typename A, bool KVQ>
__global__ void __launch_bounds__(kThreads, 1) decode_wide_kernel(const Args<W, A, KVQ> a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.batch, E = a.embed, H = a.heads, D = a.head_dim, V = a.vocab_pad;
  const int C = a.cache_len, Wn = a.window, L = a.layers;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* const red = smem;                      // 64
  float* const gred = red + 64;                 // kWarps * 4 * kMaxBatch
  float* const rows = gred + kWarps * 4 * kMaxBatch;  // B * E
  float* const xs = rows + (size_t)B * E;       // union
  const bool quantized = a.wscale != nullptr;
  constexpr int VA = Vec<A>::N;  // K/V elements per 16-byte load

  if (blockIdx.x == 0 && tid < B) a.token[tid] = a.prompts[tid * a.prompt_width];
  grid.sync();
  PhaseClock clock(a.clock);
  auto sync = [&](int phase) {
    grid.sync();
    clock.mark(phase);
  };

  for (int pos = 0; pos < a.num_steps; ++pos) {
    const int prow = pos < Wn - 1 ? pos : Wn - 1;
    const int n = pos + 1;
    // Key splits per (row, head) this step: enough items to cover the grid,
    // at least 64 keys each.
    int S = (n + 63) / 64;
    if (S > a.splits) S = a.splits;
    const int per = (n + S - 1) / S;
    const int flushed = pos / kTail * kTail;

    for (int layer = 0; layer < L; ++layer) {
      const W* big = a.big_w + (size_t)layer * 8 * E * E;
      const float* wsc = quantized ? a.wscale + (size_t)layer * 8 * E : nullptr;

      // P1: ln_1 and the qkv columns.
      if (layer == 0) {
#pragma unroll 2
        for (int i = tid * VA; i < B * E; i += kThreads * VA) {
          const int b = i / E, e = i - b * E;
          float t[VA], p[VA];
          Load<A, VA>::ro(a.wte + (size_t)__ldcg(a.token + b) * E + e, t);
          Load<A, VA>::ro(a.wpe + (size_t)prow * E + e, p);
#pragma unroll
          for (int c = 0; c < VA; ++c) rows[i + c] = t[c] + p[c];
        }
      } else {
        copy_cg(rows, a.h, B * E);
      }
      __syncthreads();
      const float* ln1 = a.ln1 + (size_t)layer * 2 * E;
      rows_layer_norm<A>(rows, blockIdx.x == 0 ? a.x1 : nullptr, xs, B, E, a.eps, ln1, ln1 + E,
                         red);
      {
        const float* bias = a.qkv_b + (size_t)layer * 3 * E;
        gemv_phase<W>(xs, big, E, 3 * E, B, gred, [&](int b, int j, float y) {
          const float v = (wsc != nullptr ? y * wsc[j] : y) + bias[j];
          if (j < E) {
            a.q[b * E + j] = round_to<A>(v);
            return;
          }
          const int which = j < 2 * E ? 0 : 1, e = j - E - which * E;
          const size_t line = ((size_t)layer * 2 + which) * B + b;
          if constexpr (KVQ) {
            a.tail[(line * kTail + pos % kTail) * E + e] = from_f<A>(v);
          } else {
            a.kv[(line * C + pos) * E + e] = from_f<A>(v);
          }
        });
      }
      sync(0);

      // P2: attention. int8 K/V: first quantize this step's rows (read
      // quantized only from the step their window completes).
      if constexpr (KVQ) {
        for (int r = blockIdx.x * kWarps + warp; r < 2 * B; r += gridDim.x * kWarps) {
          const size_t line = (size_t)layer * 2 * B + r;  // (layer, which, b)
          const A* src = a.tail + (line * kTail + pos % kTail) * E;
          float m = 0.f;
#pragma unroll 4
          for (int e = lane * VA; e < E; e += 32 * VA) {
            float v[VA];
            Load<A, VA>::cg(src + e, v);
#pragma unroll
            for (int c = 0; c < VA; ++c) m = fmaxf(m, fabsf(v[c]));
          }
          for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          m = fmaxf(m, 1e-12f);
          const float inv = 127.0f / m;
          int8_t* dst = a.kq + (line * C + pos) * E;
#pragma unroll 4
          for (int e = lane * VA; e < E; e += 32 * VA) {
            float v[VA];
            Load<A, VA>::cg(src + e, v);
#pragma unroll
            for (int c = 0; c < VA; ++c)
              dst[e + c] = (int8_t)fminf(fmaxf(rintf(v[c] * inv), -127.f), 127.f);
          }
          if (lane == 0) a.ks[line * C + pos] = m * (1.0f / 127.0f);
        }
      }
      for (int item = blockIdx.x; item < B * H * S; item += gridDim.x) {
        const int b = item / (H * S), hh = (item / S) % H, s = item % S;
        const int j0 = s * per, j1 = min(n, j0 + per);
        float* const qh = xs;
        float* const sc = xs + D;
        float* const av = sc + C;
        for (int d = tid; d < D; d += kThreads) qh[d] = __ldcg(a.q + b * E + hh * D + d);
        __syncthreads();
        const size_t kline = ((size_t)layer * 2 * B + b), vline = kline + B;
        // Scores: D / VA lanes per key, each loading VA lanes of the key's
        // head (and of its band row) with one vector load; several keys per
        // warp and round, so each thread keeps several loads in flight.
        {
          const int lanes = D / VA, keys = 32 / lanes, g = lane % lanes;
          const float* qg = qh + g * VA;
#pragma unroll 4
          for (int base = j0 + warp * keys; base < j1; base += kWarps * keys) {
            const int j = base + lane / lanes;
            float part = 0.f, v[VA];
            if (j < j1) {
              float kscale = 1.f;
              if constexpr (KVQ) {
                if (j < flushed) {
                  Load<int8_t, VA>::cg(a.kq + (kline * C + j) * E + hh * D + g * VA, v);
                  kscale = __ldcg(a.ks + kline * C + j);
                } else {
                  Load<A, VA>::cg(a.tail + (kline * kTail + j % kTail) * E + hh * D + g * VA, v);
                }
              } else {
                Load<A, VA>::cg(a.kv + (kline * C + j) * E + hh * D + g * VA, v);
              }
#pragma unroll
              for (int c = 0; c < VA; ++c) part = fmaf(qg[c], v[c], part);
              part *= kscale;
              // Slot j is at distance pos - j: table row window-1-(pos-j);
              // rows outside the table give no bias. Added before scaling.
              const int r = Wn - 1 - (pos - j);
              if (a.use_rel && r >= 0) {
                Load<A, VA>::ro(a.rel + ((size_t)layer * Wn + r) * E + hh * D + g * VA, v);
#pragma unroll
                for (int c = 0; c < VA; ++c) part = fmaf(qg[c], v[c], part);
              }
            }
            for (int o = lanes / 2; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            if (j < j1 && g == 0) sc[j - j0] = part * a.softmax_scale;
          }
        }
        __syncthreads();
        float mx = -CUDART_INF_F;
        for (int j = tid; j < j1 - j0; j += kThreads) mx = fmaxf(mx, sc[j]);
        mx = block_max(mx, red);
        float local = 0.f;
        for (int j = tid; j < j1 - j0; j += kThreads) {
          const float p = expf(sc[j] - mx);
          sc[j] = p;
          local += p;
        }
        const float sum = block_sum(local, red);
        // acc[d] = sum_j p_j v_j[d]: thread (group of VA lanes, slice) over
        // every slices-th key, one vector load a key.
        const int groups = D / VA, slices = kThreads / groups;
        const int g = tid % groups, slice = tid / groups;
        float acc[VA] = {};
#pragma unroll 4
        for (int j = j0 + slice; j < j1; j += slices) {
          float p = sc[j - j0], vv[VA];
          if constexpr (KVQ) {
            if (j < flushed) {
              p *= __ldcg(a.ks + vline * C + j);
              Load<int8_t, VA>::cg(a.kq + (vline * C + j) * E + hh * D + g * VA, vv);
            } else {
              Load<A, VA>::cg(a.tail + (vline * kTail + j % kTail) * E + hh * D + g * VA, vv);
            }
          } else {
            Load<A, VA>::cg(a.kv + (vline * C + j) * E + hh * D + g * VA, vv);
          }
#pragma unroll
          for (int c = 0; c < VA; ++c) acc[c] = fmaf(p, vv[c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < VA; ++c) av[slice * D + g * VA + c] = acc[c];
        __syncthreads();
        float* out = a.part + (((size_t)b * H + hh) * kMaxSplits + s) * (D + 2);
        for (int d = tid; d < D; d += kThreads) {
          float total = 0.f;
          for (int t = 0; t < slices; ++t) total += av[t * D + d];
          out[d] = total;
        }
        if (tid == 0) {
          out[D] = mx;
          out[D + 1] = sum;
        }
        __syncthreads();
      }
      sync(1);

      // P3: merge the splits, attention-proj columns, residual on x1.
      merge_splits<A>(a.part, xs, xs + (size_t)B * E, B, H, D, E, [&](int) { return S; });
      {
        const float* bias = a.proj_b + (size_t)layer * E;
        gemv_phase<W>(xs, big + (size_t)3 * E * E, E, E, B, gred, [&](int b, int j, float y) {
          const float v = (wsc != nullptr ? y * wsc[3 * E + j] : y) + bias[j];
          a.x2[b * E + j] = __ldcg(a.x1 + b * E + j) + v;
        });
      }
      sync(2);

      // P4: ln_2 (folded into fc) and the GELU of the fc columns.
      copy_cg(rows, a.x2, B * E);
      __syncthreads();
      rows_layer_norm<A>(rows, nullptr, xs, B, E, a.eps, nullptr, nullptr, red);
      {
        const float* bias = a.fc_b + (size_t)layer * 4 * E;
        gemv_phase<W>(xs, big + (size_t)4 * E * E, E, 4 * E, B, gred,
                      [&](int b, int j, float y) {
          const float v = (wsc != nullptr ? y * wsc[4 * E + j] : y) + bias[j];
          a.hid[(size_t)b * 4 * E + j] = round_to<A>(gelu_tanh(v));
        });
      }
      sync(3);

      // P5: mlp-proj columns and the residual on x2.
      copy_cg(xs, a.hid, B * 4 * E);
      __syncthreads();
      {
        const float* bias = a.fp_b + (size_t)layer * E;
        const float* fsc = quantized ? a.fpscale + (size_t)layer * E : nullptr;
        gemv_phase<W>(xs, a.fp_w + (size_t)layer * 4 * E * E, 4 * E, E, B, gred,
                      [&](int b, int j, float y) {
          const float v = fsc != nullptr ? y * fsc[j] : y;
          a.h[b * E + j] = (__ldcg(a.x2 + b * E + j) + v) + bias[j];
        });
      }
      sync(4);
    }

    // P6: tied logits, standardize(h) @ logits_w + logits_b.
    copy_cg(rows, a.h, B * E);
    __syncthreads();
    rows_layer_norm<A>(rows, nullptr, xs, B, E, a.eps, nullptr, nullptr, red);
    gemv_phase<A>(xs, a.logits_w, E, V, B, gred, [&](int b, int j, float y) {
      a.logits[(size_t)b * V + j] = y + a.logits_b[j];
    });
    sync(5);

    // P7: block b samples row b and feeds the next input back.
    if (blockIdx.x < B) {
      const int b = blockIdx.x;
      float* const lg = xs;
      const bool last = pos == a.num_steps - 1 && a.logits_out != nullptr;
      for (int v = tid; v < V; v += kThreads) {
        lg[v] = __ldcg(a.logits + (size_t)b * V + v);
        if (last) a.logits_out[(size_t)b * V + v] = lg[v];
      }
      __syncthreads();
      const int next = sample_row(lg, lg + V, lg + 2 * V, lg + 3 * V, V, a.temps[b], a.topk[b],
                                  a.topp[b], a.seed, (unsigned)pos, (unsigned)b, red);
      if (tid == 0) {
        const int plen = a.plens[b];
        const int col = pos - plen + 1;
        if (col >= 0 && col < a.out_len) a.tokens[(size_t)b * a.out_len + col] = next;
        a.token[b] = pos + 1 < plen ? a.prompts[b * a.prompt_width + pos + 1] : next;
      }
    }
    sync(6);
  }
}

template <typename W, typename A, bool KVQ>
int launch(Args<W, A, KVQ>& a, int device, int grid, cudaStream_t stream) {
  auto kernel = decode_wide_kernel<W, A, KVQ>;
  const size_t smem = sizeof(float) * smem_floats(a.batch, a.embed, a.head_dim, a.cache_len,
                                                  a.vocab_pad);
  if (smem > (size_t)kMaxSharedBytes || a.batch < 1 || a.batch > kMaxBatch ||
      a.embed % 16 != 0 || a.head_dim % 8 != 0 || a.head_dim > 128 ||
      kThreads % a.head_dim != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, cooperative = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device)) !=
      cudaSuccess)
    return (int)err;
  if (!cooperative) return (int)cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (grid <= 0) grid = sms;
  // Every block must be resident at once, or the first grid barrier never
  // opens: refuse such a grid instead of launching it.
  if (per_sm < 1 || grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  a.splits = grid / (a.batch * a.heads);
  if (a.splits < 1) a.splits = 1;
  if (a.splits > kMaxSplits) a.splits = kMaxSplits;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W, typename A, bool KVQ>
int run(int device, int grid, const void* const* p, int scratch_size, const int* dims,
        unsigned seed, float softmax_scale, float eps, void* stream) {
  Args<W, A, KVQ> a;
  a.big_w = static_cast<const W*>(p[0]);
  a.fp_w = static_cast<const W*>(p[1]);
  a.wscale = static_cast<const float*>(p[2]);
  a.fpscale = static_cast<const float*>(p[3]);
  a.wte = static_cast<const A*>(p[4]);
  a.logits_w = static_cast<const A*>(p[5]);
  a.wpe = static_cast<const A*>(p[6]);
  a.ln1 = static_cast<const float*>(p[7]);
  a.qkv_b = static_cast<const float*>(p[8]);
  a.proj_b = static_cast<const float*>(p[9]);
  a.fc_b = static_cast<const float*>(p[10]);
  a.fp_b = static_cast<const float*>(p[11]);
  a.logits_b = static_cast<const float*>(p[12]);
  a.rel = static_cast<const A*>(p[13]);
  a.kv = static_cast<A*>(const_cast<void*>(p[14]));
  a.kq = static_cast<int8_t*>(const_cast<void*>(p[15]));
  a.ks = static_cast<float*>(const_cast<void*>(p[16]));
  a.tail = static_cast<A*>(const_cast<void*>(p[17]));
  a.prompts = static_cast<const int*>(p[18]);
  a.plens = static_cast<const int*>(p[19]);
  a.temps = static_cast<const float*>(p[20]);
  a.topk = static_cast<const float*>(p[21]);
  a.topp = static_cast<const float*>(p[22]);
  a.tokens = static_cast<int*>(const_cast<void*>(p[23]));
  a.logits_out = static_cast<float*>(const_cast<void*>(p[24]));
  float* scratch = static_cast<float*>(const_cast<void*>(p[25]));
  a.clock = static_cast<unsigned long long*>(const_cast<void*>(p[26]));
  a.batch = dims[0];
  a.prompt_width = dims[1];
  a.layers = dims[2];
  a.heads = dims[3];
  a.head_dim = dims[4];
  a.embed = dims[5];
  a.cache_len = dims[6];
  a.window = dims[7];
  a.vocab_pad = dims[8];
  a.num_steps = dims[9];
  a.out_len = dims[10];
  a.use_rel = dims[11];
  a.seed = seed;
  a.softmax_scale = softmax_scale;
  a.eps = eps;
  const int B = a.batch, E = a.embed;
  if ((size_t)scratch_size < scratch_floats(B, E, a.heads, a.head_dim, a.vocab_pad))
    return (int)cudaErrorInvalidValue;
  if (KVQ ? (a.kq == nullptr || a.ks == nullptr || a.tail == nullptr) : a.kv == nullptr)
    return (int)cudaErrorInvalidValue;
  a.x1 = scratch;
  a.q = a.x1 + (size_t)B * E;
  a.x2 = a.q + (size_t)B * E;
  a.h = a.x2 + (size_t)B * E;
  a.hid = a.h + (size_t)B * E;
  a.logits = a.hid + (size_t)B * 4 * E;
  a.part = a.logits + (size_t)B * a.vocab_pad;
  a.token = reinterpret_cast<int*>(a.part + (size_t)B * a.heads * kMaxSplits * (a.head_dim + 2));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch<W, A, KVQ>(a, device, grid, static_cast<cudaStream_t>(stream));
}

}  // namespace

// weight_kind: 0 float32, 1 bfloat16, 2 int8 (bf16 tables and activations);
// kv_quant: int8 K/V with a float window. Pointers in the order of
// ops/decode_kernel_wide.py::decode_wide; unused ones are null.
extern "C" int decode_wide(
    int weight_kind, int kv_quant, int device, int grid, const void* big_w, const void* fp_w,
    const void* wscale, const void* fpscale, const void* wte, const void* logits_w,
    const void* wpe, const void* ln1, const void* qkv_b, const void* proj_b, const void* fc_b,
    const void* fp_b, const void* logits_b, const void* rel, void* kv, void* kq, void* ks,
    void* tail, const void* prompts, const void* plens, const void* temps, const void* topk,
    const void* topp, void* tokens, void* logits_out, void* scratch, void* clock,
    int scratch_size,
    int batch, int prompt_width, int layers, int heads, int head_dim, int embed, int cache_len,
    int window, int vocab_pad, int num_steps, int out_len, int use_rel, unsigned seed,
    float softmax_scale, float eps, void* stream) {
  const void* p[] = {big_w, fp_w, wscale, fpscale, wte, logits_w, wpe, ln1, qkv_b,
                     proj_b, fc_b, fp_b, logits_b, rel, kv, kq, ks, tail, prompts,
                     plens, temps, topk, topp, tokens, logits_out, scratch, clock};
  const int dims[] = {batch, prompt_width, layers, heads, head_dim, embed, cache_len,
                      window, vocab_pad, num_steps, out_len, use_rel};
  using bf16 = __nv_bfloat16;
  switch (weight_kind * 2 + (kv_quant ? 1 : 0)) {
    case 0: return run<float, float, false>(device, grid, p, scratch_size, dims, seed,
                                            softmax_scale, eps, stream);
    case 1: return run<float, float, true>(device, grid, p, scratch_size, dims, seed,
                                           softmax_scale, eps, stream);
    case 2: return run<bf16, bf16, false>(device, grid, p, scratch_size, dims, seed,
                                          softmax_scale, eps, stream);
    case 3: return run<bf16, bf16, true>(device, grid, p, scratch_size, dims, seed,
                                         softmax_scale, eps, stream);
    case 4: return run<int8_t, bf16, false>(device, grid, p, scratch_size, dims, seed,
                                            softmax_scale, eps, stream);
    case 5: return run<int8_t, bf16, true>(device, grid, p, scratch_size, dims, seed,
                                           softmax_scale, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
