// spec_decode: batch-1 speculative decoding of the Music Transformer in one
// kernel launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_spec.py
// (_spec_decode_kernel). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_spec.py::speculative_generate_reference.
//
// One thread block runs the whole generation, a loop over verify blocks of T
// positions starting at p0. Each block:
//   1. drafts T-1 tokens: the latest j in [1, p0-(T-1)] whose 2-gram
//      (ids[j-1], ids[j]) equals (ids[p0-1], ids[p0]), else whose 1-gram
//      ids[j] equals ids[p0], else j = 0; input t is ids[p0+t] inside the
//      prompt or at t = 0, ids[j+t] after it;
//   2. runs one forward pass over the T rows: embedding, pre-LN layers (ln_2
//      and ln_f folded into the weights at pack time), K and V appended for
//      all T positions, attention of row t over keys c <= p0+t with the
//      Music-Transformer relative bias, tied logits;
//   3. samples the rows in order, as the sequential kernel samples position
//      p0+t (same Philox bits: row 0, step p0+t), and stops at the first row
//      whose sample differs from the next drafted input;
//   4. emits the accepted prefix (1 to T tokens) and moves p0 past it.
// The id stream lives in shared memory; one thread decides what every thread
// then reads from shared memory behind a barrier, so all threads leave the
// loop together. stats = [blocks, generation blocks, final p0, 0...].
//
// What bounds it on the H100: like decode_generate, one SM reads every packed
// weight (12.6 MB in bf16 for the default model) from L2 once per verify
// block. The design applies each weight element, once loaded, to all T rows
// (up to kRowChunk rows per pass: T accumulators per output), so a block of T
// positions costs about one sequential step of weight traffic plus T rows of
// FMAs and attention. Attention runs row by row over one H x C score buffer
// in shared memory, which bounds cache_len and T together
// (ops/decode_kernel_spec.py::spec_kernel_fits). Keys past p0+t are never
// read, so stale rows of rejected drafts and uninitialised scratch never
// enter a product.
//
// Numerics as decode_generate: matmul operands rounded to the weight type Wt,
// float32 accumulation; q rounded to Wt before the scores, softmax weights to
// Wt before the AV product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: spec_decode(...), returns cudaGetLastError() after launch.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

constexpr int kMaxBlock = 16;  // largest T (SPEC_BLOCK_MAX in decode_kernel_spec.py)
constexpr int kRowChunk = 8;   // rows one pass over a weight feeds
constexpr int kCols = 4;       // adjacent output columns a thread owns in gemm_rows

// The block's static shared state, beside the dynamic buffer smem_floats()
// sizes; both count against kMaxSharedBytes (SPEC_STATIC_SHARED_BYTES in
// decode_kernel_spec.py).
struct BlockState {
  int in[kMaxBlock];    // the block's input tokens
  int samp[kMaxBlock];  // the block's samples
  int go;               // 1 while the samples match the drafts
};
constexpr int kStaticSharedBytes = static_shared_bytes(sizeof(BlockState));
static_assert(kStaticSharedBytes == 144, "mirrored in Python");

template <typename T>
struct Args {
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
  T* kcache;           // (L, C, E), C = cache_rows
  T* vcache;           // (L, C, E)
  const int* prompt;   // (plen,)
  int* out;            // (length + 8,): tokens, then stats
  int plen, layers, heads, head_dim, embed, cache_rows, window, vocab_pad, length, block;
  int use_rel;
  unsigned seed;
  float temp, topk, topp, softmax_scale, eps;
};

// y[r, j] = sum_i x[r, i] * w[i, j] for R rows of x (stride K) and a
// row-major (K, N) weight, N a multiple of kCols; y has stride N. Each thread
// owns kCols adjacent columns and a slice of K, loads each weight element of
// them once and applies it to all R rows; the slices' partial sums are added
// in a fixed order. partial holds R * kThreads * kCols floats.
template <typename T, int R>
__device__ __noinline__ void gemm_rows(const float* x, const T* __restrict__ w, int K, int N,
                                       float* y, float* partial) {
  const int tid = threadIdx.x, groups = N / kCols;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  for (int u = tid; u < splits * groups; u += kThreads) {
    const int g = u % groups, part = u / groups;
    const int k0 = part * K / splits, k1 = (part + 1) * K / splits;
    float acc[R][kCols] = {};
    const T* col = w + g * kCols;
#pragma unroll 4
    for (int i = k0; i < k1; ++i) {
      float v[kCols];
      Vec4<T>::load(col + (size_t)i * N, v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xi = x[r * K + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xi, v[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* out = splits == 1 ? y + r * N : partial + (part * R + r) * N;
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[g * kCols + c] = acc[r][c];
    }
  }
  __syncthreads();
  if (splits == 1) return;
  for (int idx = tid; idx < R * N; idx += kThreads) {
    const int r = idx / N, j = idx - r * N;
    float acc = 0.f;
    for (int p = 0; p < splits; ++p) acc += partial[(p * R + r) * N + j];
    y[idx] = acc;
  }
  __syncthreads();
}

// gemm_rows over `rows` rows, kRowChunk rows per pass over the weight.
template <typename T>
__device__ void gemm(const float* x, const T* w, int K, int N, float* y, int rows,
                     float* partial) {
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const float* xr = x + r0 * K;
    float* yr = y + r0 * N;
    switch (min(kRowChunk, rows - r0)) {
      case 1: gemm_rows<T, 1>(xr, w, K, N, yr, partial); break;
      case 2: gemm_rows<T, 2>(xr, w, K, N, yr, partial); break;
      case 3: gemm_rows<T, 3>(xr, w, K, N, yr, partial); break;
      case 4: gemm_rows<T, 4>(xr, w, K, N, yr, partial); break;
      case 5: gemm_rows<T, 5>(xr, w, K, N, yr, partial); break;
      case 6: gemm_rows<T, 6>(xr, w, K, N, yr, partial); break;
      case 7: gemm_rows<T, 7>(xr, w, K, N, yr, partial); break;
      default: gemm_rows<T, 8>(xr, w, K, N, yr, partial); break;
    }
  }
}

__host__ __device__ inline size_t smem_floats(int E, int H, int C, int V, int T) {
  const size_t ids = ((size_t)C + 3) & ~(size_t)3;
  const size_t hid = 4 * (size_t)E * T > (size_t)kThreads * 8 ? 4 * (size_t)E * T
                                                               : (size_t)kThreads * 8;
  const size_t rows = T < kRowChunk ? T : kRowChunk;
  const size_t scores = (size_t)H * C, partial = rows * kThreads * kCols;
  return 64 + ids + 7 * (size_t)E * T + hid + (size_t)T * V + 3 * (size_t)V +
         (scores > partial ? scores : partial);
}

template <typename Wt>
__global__ void __launch_bounds__(kThreads) spec_decode_kernel(const Args<Wt> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ BlockState st;
  const int E = a.embed, H = a.heads, D = a.head_dim, C = a.cache_rows;
  const int V = a.vocab_pad, Wn = a.window, T = a.block, plen = a.plen;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Shared layout; spec_smem_bytes() in Python mirrors it.
  float* red = smem;                                    // 64 floats
  int* ids = reinterpret_cast<int*>(red + 64);          // C ints: the id stream
  float* h = red + 64 + ((C + 3) & ~3);                 // T x E residual stream
  float* x1 = h + T * E;                                // T x E ln_1 output
  float* xw = x1 + T * E;                               // T x E matmul operand / q
  float* act = xw + T * E;                              // T x E attention / MLP out
  float* qkv = act + T * E;                             // T x 3E
  float* hid = qkv + 3 * T * E;                         // T x 4E, or the AV partial sums
  float* logits = hid + max(4 * E * T, kThreads * 8);   // T x V
  float* scaled = logits + T * V;                       // V
  float* scored = scaled + V;                           // V
  float* expv = scored + V;                             // V
  float* work = expv + V;  // H x C scores of one row, or gemm partial sums

  for (int i = tid; i < C; i += kThreads) ids[i] = i < plen ? a.prompt[i] : 0;
  __syncthreads();

  // Every thread keeps the same copy of the loop state.
  int p0 = 0, blocks = 0, gen_blocks = 0;
  const int end = plen - 1 + a.length;
  while (p0 < end) {
    // --- Draft: the latest earlier occurrence of the context tail. ---------
    const int last1 = ids[p0], last2 = p0 >= 1 ? ids[p0 - 1] : 0;
    int best1 = -1, best2 = -1;
    for (int c = 1 + tid; c <= p0 - (T - 1); c += kThreads) {
      if (ids[c] == last1) {
        best1 = c;
        if (ids[c - 1] == last2) best2 = c;
      }
    }
    best1 = block_max_int(best1, reinterpret_cast<int*>(red));
    best2 = block_max_int(best2, reinterpret_cast<int*>(red) + kWarps);
    const int j = best2 >= 0 ? best2 : (best1 >= 0 ? best1 : 0);
    if (tid < T) st.in[tid] = (p0 + tid < plen || tid == 0) ? ids[p0 + tid] : ids[j + tid];
    __syncthreads();
    // Accepted inputs are the true stream; rejected ones are overwritten
    // before any later read.
    if (tid < T) ids[p0 + tid] = st.in[tid];

    // --- One forward pass over the T rows. ---------------------------------
    for (int idx = tid; idx < T * E; idx += kThreads) {
      const int t = idx / E, e = idx - t * E;
      const int prow = min(p0 + t, Wn - 1);
      h[idx] = to_f(a.wte[(size_t)st.in[t] * E + e]) + to_f(a.wpe[(size_t)prow * E + e]);
    }
    __syncthreads();

    for (int layer = 0; layer < a.layers; ++layer) {
      const float* ln1 = a.ln1 + (size_t)layer * 2 * E;
      layer_norm_rows<Wt>(h, x1, xw, T, E, a.eps, ln1, ln1 + E);
      gemm<Wt>(xw, a.qkv_w + (size_t)layer * E * 3 * E, E, 3 * E, qkv, T, work);
      const float* qkv_b = a.qkv_b + (size_t)layer * 3 * E;
      Wt* krows = a.kcache + (size_t)layer * C * E;
      Wt* vrows = a.vcache + (size_t)layer * C * E;
      for (int idx = tid; idx < T * 3 * E; idx += kThreads) {
        const int t = idx / (3 * E), e = idx - t * 3 * E;
        const float v = qkv[idx] + qkv_b[e];
        if (e < E) xw[t * E + e] = round_to<Wt>(v);  // q in the KV type
        else if (e < 2 * E) krows[(size_t)(p0 + t) * E + (e - E)] = from_f<Wt>(v);
        else vrows[(size_t)(p0 + t) * E + (e - 2 * E)] = from_f<Wt>(v);
      }
      __syncthreads();

      const Wt* rel = a.rel + (size_t)layer * Wn * E;
      for (int t = 0; t < T; ++t) {
        // Row t at position pos attends over slots [0, pos], all written.
        const int pos = p0 + t, n = pos + 1;
        const float* q = xw + t * E;
#pragma unroll 4
        for (int idx = tid; idx < H * n; idx += kThreads) {
          const int hh = idx / n, c = idx - hh * n;
          const float* qh = q + hh * D;
          float acc = head_dot<Wt>(qh, krows + (size_t)c * E + hh * D, D);
          if (a.use_rel) {
            // Slot c is at distance pos - c: E row window-1-(pos-c); rows
            // outside the table give no bias. Added before scaling.
            const int r = Wn - 1 - (pos - c);
            if (r >= 0) acc += head_dot<Wt>(qh, rel + (size_t)r * E + hh * D, D);
          }
          work[hh * C + c] = acc * a.softmax_scale;
        }
        __syncthreads();

        // Softmax per head, one warp per head; weights rounded to T.
        for (int hh = warp; hh < H; hh += kWarps) {
          float* row = work + hh * C;
          float m = -CUDART_INF_F;
          for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
          for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          float sum = 0.f;
          for (int c = lane; c < n; c += 32) {
            const float p = expf(row[c] - m);
            row[c] = p;
            sum += p;
          }
          for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          for (int c = lane; c < n; c += 32) row[c] = round_to<Wt>(row[c] / sum);
        }
        __syncthreads();

        // act[t, e] = sum_c w[head(e), c] * V[c, e]: each thread owns
        // Vec<Wt>::N adjacent lanes (one head) and a slice of the slots.
        constexpr int VN = Vec<Wt>::N;
        const int groups = E / VN;
        const int splits = groups >= kThreads ? 1 : kThreads / groups;
        for (int u = tid; u < splits * groups; u += kThreads) {
          const int g = u % groups, part = u / groups;
          const int c0 = part * n / splits, c1 = (part + 1) * n / splits;
          const float* wrow = work + (g * VN / D) * C;
          float acc[VN] = {};
#pragma unroll 8
          for (int c = c0; c < c1; ++c) {
            float v[VN];
            Vec<Wt>::load(vrows + (size_t)c * E + g * VN, v);
#pragma unroll
            for (int k = 0; k < VN; ++k) acc[k] = fmaf(wrow[c], v[k], acc[k]);
          }
#pragma unroll
          for (int k = 0; k < VN; ++k) {
            if (splits == 1) act[t * E + g * VN + k] = round_to<Wt>(acc[k]);
            else hid[part * E + g * VN + k] = acc[k];
          }
        }
        __syncthreads();
        if (splits > 1) {
          for (int e = tid; e < E; e += kThreads) {
            float acc = 0.f;
            for (int p = 0; p < splits; ++p) acc += hid[p * E + e];
            act[t * E + e] = round_to<Wt>(acc);
          }
          __syncthreads();
        }
      }

      // qkv's first T x E floats hold the projection.
      gemm<Wt>(act, a.proj_w + (size_t)layer * E * E, E, E, qkv, T, work);
      const float* proj_b = a.proj_b + (size_t)layer * E;
      for (int idx = tid; idx < T * E; idx += kThreads)
        h[idx] = x1[idx] + (qkv[idx] + proj_b[idx % E]);  // x2
      __syncthreads();

      layer_norm_rows<Wt>(h, nullptr, xw, T, E, a.eps, nullptr, nullptr);
      gemm<Wt>(xw, a.fc_w + (size_t)layer * E * 4 * E, E, 4 * E, hid, T, work);
      const float* fc_b = a.fc_b + (size_t)layer * 4 * E;
      for (int idx = tid; idx < T * 4 * E; idx += kThreads)
        hid[idx] = round_to<Wt>(gelu_tanh(hid[idx] + fc_b[idx % (4 * E)]));
      __syncthreads();
      gemm<Wt>(hid, a.fp_w + (size_t)layer * 4 * E * E, 4 * E, E, act, T, work);
      const float* fp_b = a.fp_b + (size_t)layer * E;
      for (int idx = tid; idx < T * E; idx += kThreads)
        h[idx] = (h[idx] + act[idx]) + fp_b[idx % E];
      __syncthreads();
    }

    // Tied logits: standardize(h) @ wte_t + logits_b.
    layer_norm_rows<Wt>(h, nullptr, xw, T, E, a.eps, nullptr, nullptr);
    gemm<Wt>(xw, a.wte_t, E, V, logits, T, work);
    for (int idx = tid; idx < T * V; idx += kThreads) logits[idx] += a.logits_b[idx % V];
    __syncthreads();

    // --- Sample the rows in order; stop at the first mismatch. -------------
    // Row t matches when it has a successor in the block that is a prompt
    // token (forced) or equals its sample; n_emit = 1 + leading matches.
    int n_emit = T;
    for (int t = 0; t < T; ++t) {
      const int s = sample_row(logits + t * V, scaled, scored, expv, V, a.temp, a.topk,
                               a.topp, a.seed, (unsigned)(p0 + t), 0u, red);
      if (tid == 0) {
        st.samp[t] = s;
        st.go = t < T - 1 && (p0 + t + 1 < plen || s == st.in[t + 1]);
      }
      __syncthreads();
      // st.go is rewritten only after the next sample_row's barriers, which
      // every thread reaches after this read.
      if (!st.go) {
        n_emit = t + 1;
        break;
      }
    }

    // --- Emit: sample t follows position p0+t -> output slot p0+t-(plen-1).
    if (tid == 0) {
      for (int t = 0; t < n_emit; ++t) {
        const int slot = p0 + t - (plen - 1);
        if (slot >= 0 && slot < a.length) a.out[slot] = st.samp[t];
      }
      // The next block's first input is the last emitted sample.
      if (p0 + n_emit >= plen) ids[p0 + n_emit] = st.samp[n_emit - 1];
    }
    gen_blocks += p0 >= plen - 1 ? 1 : 0;
    blocks += 1;
    p0 += n_emit;
    __syncthreads();
  }
  if (tid < 8) {
    const int stats[3] = {blocks, gen_blocks, p0};
    a.out[a.length + tid] = tid < 3 ? stats[tid] : 0;
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * smem_floats(a.embed, a.heads, a.cache_rows, a.vocab_pad, a.block);
  if (smem + kStaticSharedBytes > (size_t)kMaxSharedBytes || a.head_dim % 8 != 0 || a.embed % 8 != 0 ||
      a.vocab_pad % kCols != 0 || a.block < 2 || a.block > kMaxBlock || a.plen < 1 ||
      a.plen - 1 + a.length + a.block > a.cache_rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      spec_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spec_decode_kernel<T><<<1, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int device, const void* const* ptrs, const int* ints, unsigned seed,
        const float* floats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args<T> a;
  a.wte = static_cast<const T*>(ptrs[0]);
  a.wte_t = static_cast<const T*>(ptrs[1]);
  a.wpe = static_cast<const T*>(ptrs[2]);
  a.ln1 = static_cast<const float*>(ptrs[3]);
  a.qkv_w = static_cast<const T*>(ptrs[4]);
  a.qkv_b = static_cast<const float*>(ptrs[5]);
  a.proj_w = static_cast<const T*>(ptrs[6]);
  a.proj_b = static_cast<const float*>(ptrs[7]);
  a.fc_w = static_cast<const T*>(ptrs[8]);
  a.fc_b = static_cast<const float*>(ptrs[9]);
  a.fp_w = static_cast<const T*>(ptrs[10]);
  a.fp_b = static_cast<const float*>(ptrs[11]);
  a.logits_b = static_cast<const float*>(ptrs[12]);
  a.rel = static_cast<const T*>(ptrs[13]);
  a.kcache = static_cast<T*>(const_cast<void*>(ptrs[14]));
  a.vcache = static_cast<T*>(const_cast<void*>(ptrs[15]));
  a.prompt = static_cast<const int*>(ptrs[16]);
  a.out = static_cast<int*>(const_cast<void*>(ptrs[17]));
  a.plen = ints[0];
  a.layers = ints[1];
  a.heads = ints[2];
  a.head_dim = ints[3];
  a.embed = ints[4];
  a.cache_rows = ints[5];
  a.window = ints[6];
  a.vocab_pad = ints[7];
  a.length = ints[8];
  a.block = ints[9];
  a.use_rel = ints[10];
  a.seed = seed;
  a.temp = floats[0];
  a.topk = floats[1];
  a.topp = floats[2];
  a.softmax_scale = floats[3];
  a.eps = floats[4];
  return launch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int spec_decode(
    int bf16, int device, const void* wte, const void* wte_t, const void* wpe,
    const void* ln1, const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* fc_w, const void* fc_b, const void* fp_w,
    const void* fp_b, const void* logits_b, const void* rel, void* kcache, void* vcache,
    const void* prompt, void* out, int plen, int layers, int heads, int head_dim, int embed,
    int cache_rows, int window, int vocab_pad, int length, int block, int use_rel,
    unsigned seed, float temp, float topk, float topp, float softmax_scale, float eps,
    void* stream) {
  const void* ptrs[18] = {wte, wte_t, wpe, ln1, qkv_w, qkv_b, proj_w, proj_b, fc_w,
                          fc_b, fp_w, fp_b, logits_b, rel, kcache, vcache, prompt, out};
  const int ints[11] = {plen, layers, heads, head_dim, embed, cache_rows, window,
                        vocab_pad, length, block, use_rel};
  const float floats[5] = {temp, topk, topp, softmax_scale, eps};
  auto go = bf16 ? run<__nv_bfloat16> : run<float>;
  return go(device, ptrs, ints, seed, floats, stream);
}
