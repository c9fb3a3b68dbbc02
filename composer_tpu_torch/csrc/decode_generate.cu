// decode_generate: the whole autoregressive generation loop of the Music
// Transformer in one kernel launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels composer_tpu/ops/decode_kernel_batched.py
// (_batched_kernel, B > 1) and composer_tpu/ops/decode_kernel.py
// (_decode_kernel, B = 1). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_batched.py::decode_generate_reference.
//
// One thread block per sequence; the block loops over every step and layer:
// embedding, pre-LN layers (ln_2 and ln_f folded into the weights at pack
// time), KV append, attention with the Music-Transformer relative bias,
// tied logits, temperature, top-k / top-p, Gumbel-max with a counter-based
// Philox4x32-10, and token feedback. Weights are read from L2 every step
// (about 12.6 MB per block per step in bf16 for the default model); only B
// of the 132 SMs are busy. The H x C float32 scores live in shared memory,
// which bounds the cache length (ops/decode_kernel_batched.py::kernel_fits).
//
// Numerics: matmul operands are rounded to the weight type T and accumulated
// in float32; q is rounded to the KV type (T) before the scores, the softmax
// weights to T before the AV product. The nucleus mass is summed in double.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: decode_generate(...), returns cudaGetLastError() after launch.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// Split-K partial sums: at most kThreads threads x 8 columns each.
constexpr int kPartial = kThreads * 8;
// Static shared memory (s_token) beside the dynamic buffer; both count
// against kMaxSharedBytes (STATIC_SHARED_BYTES in decode_kernel_batched.py).
constexpr int kStaticSharedBytes = static_shared_bytes(sizeof(int));

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
  T* kcache;           // (L, B*C, E)
  T* vcache;           // (L, B*C, E)
  const int* prompts;  // (B, P)
  const int* plens;    // (B,)
  const float* temps;  // (B,)
  const float* topk;   // (B,), Vpad+1 = off
  const float* topp;   // (B,), 2.0 = off
  int* tokens;         // (B, out_len)
  float* logits_out;   // (B, Vpad) last step's logits, or null
  int batch, prompt_width, layers, heads, head_dim, embed, cache_len, window, vocab_pad;
  int num_steps, start_step, out_len, use_rel;
  unsigned seed;
  float softmax_scale, eps;
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_generate_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_token;
  const int E = a.embed, H = a.heads, D = a.head_dim, C = a.cache_len;
  const int V = a.vocab_pad, Wn = a.window, B = a.batch;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Shared layout; kernel_smem_bytes() in Python mirrors it.
  float* red = smem;               // 64 floats (also 16 doubles)
  float* h = red + 64;             // residual stream
  float* x1 = h + E;               // ln_1 output
  float* xw = x1 + E;              // matmul operand rounded to T
  float* act = xw + E;
  float* qkv = act + E;            // 3E
  float* hid = qkv + 3 * E;        // 4E
  float* logits = hid + 4 * E;     // V
  float* scaled = logits + V;      // V
  float* scored = scaled + V;      // V
  float* expv = scored + V;        // V
  float* scores = expv + V;        // H * C
  float* partial = scores + H * C; // kPartial

  const float temp = a.temps[s];
  const int plen = a.plens[s];
  const float topk = a.topk[s], topp = a.topp[s];
  if (tid == 0) s_token = a.prompts[s * a.prompt_width + a.start_step];
  __syncthreads();

  for (int pos = a.start_step; pos < a.num_steps; ++pos) {
    const int token = s_token;
    const int prow = pos < Wn - 1 ? pos : Wn - 1;
    for (int e = tid; e < E; e += kThreads)
      h[e] = to_f(a.wte[(size_t)token * E + e]) + to_f(a.wpe[(size_t)prow * E + e]);
    __syncthreads();

    for (int layer = 0; layer < a.layers; ++layer) {
      const float* ln1 = a.ln1 + (size_t)layer * 2 * E;
      layer_norm<T>(h, x1, xw, E, a.eps, ln1, ln1 + E, red);

      gemv<T>(xw, a.qkv_w + (size_t)layer * E * 3 * E, E, 3 * E, qkv, partial);
      const float* qkv_b = a.qkv_b + (size_t)layer * 3 * E;
      const size_t cache_base = ((size_t)layer * B + s) * C * E;
      T* krows = a.kcache + cache_base;
      T* vrows = a.vcache + cache_base;
      for (int e = tid; e < 3 * E; e += kThreads) {
        const float v = qkv[e] + qkv_b[e];
        if (e < E) xw[e] = round_to<T>(v);  // q in the KV type
        else if (e < 2 * E) krows[(size_t)pos * E + (e - E)] = from_f<T>(v);
        else vrows[(size_t)pos * E + (e - 2 * E)] = from_f<T>(v);
      }
      __syncthreads();

      // Scores for slots [0, pos]: one (head, slot) pair per thread, slots
      // of one head on adjacent threads.
      const int n = pos + 1;
      const T* rel = a.rel + (size_t)layer * Wn * E;
#pragma unroll 4
      for (int idx = tid; idx < H * n; idx += kThreads) {
        const int hh = idx / n, j = idx - hh * n;
        const float* qh = xw + hh * D;
        float acc = head_dot<T>(qh, krows + (size_t)j * E + hh * D, D);
        if (a.use_rel) {
          // Slot j is at distance pos - j: E row window-1-(pos-j); rows
          // outside the table give no bias. Added before scaling.
          const int r = Wn - 1 - (pos - j);
          if (r >= 0) acc += head_dot<T>(qh, rel + (size_t)r * E + hh * D, D);
        }
        scores[hh * C + j] = acc * a.softmax_scale;
      }
      __syncthreads();

      // Softmax per head, one warp per head; weights rounded to T.
      for (int hh = warp; hh < H; hh += kWarps) {
        float* row = scores + hh * C;
        float m = -CUDART_INF_F;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
        for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float p = expf(row[j] - m);
          row[j] = p;
          sum += p;
        }
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / sum);
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

      gemv<T>(xw, a.proj_w + (size_t)layer * E * E, E, E, act, partial);
      const float* proj_b = a.proj_b + (size_t)layer * E;
      for (int e = tid; e < E; e += kThreads) h[e] = x1[e] + (act[e] + proj_b[e]);  // x2
      __syncthreads();

      layer_norm<T>(h, nullptr, xw, E, a.eps, nullptr, nullptr, red);
      gemv<T>(xw, a.fc_w + (size_t)layer * E * 4 * E, E, 4 * E, hid, partial);
      const float* fc_b = a.fc_b + (size_t)layer * 4 * E;
      for (int j = tid; j < 4 * E; j += kThreads) {
        const float x = hid[j] + fc_b[j];
        hid[j] = round_to<T>(gelu_tanh(x));
      }
      __syncthreads();
      gemv<T>(hid, a.fp_w + (size_t)layer * 4 * E * E, 4 * E, E, act, partial);
      const float* fp_b = a.fp_b + (size_t)layer * E;
      for (int e = tid; e < E; e += kThreads) h[e] = (h[e] + act[e]) + fp_b[e];
      __syncthreads();
    }

    // Tied logits: standardize(h) @ wte_t + logits_b.
    layer_norm<T>(h, nullptr, xw, E, a.eps, nullptr, nullptr, red);
    gemv<T>(xw, a.wte_t, E, V, logits, partial);
    for (int v = tid; v < V; v += kThreads) {
      logits[v] += a.logits_b[v];
      if (a.logits_out != nullptr && pos == a.num_steps - 1)
        a.logits_out[(size_t)s * V + v] = logits[v];
    }
    __syncthreads();

    const int next = sample_row(logits, scaled, scored, expv, V, temp, topk, topp, a.seed,
                                (unsigned)pos, (unsigned)s, red);

    if (tid == 0) {
      const int col = pos - plen + 1;
      if (col >= 0 && col < a.out_len) a.tokens[(size_t)s * a.out_len + col] = next;
      s_token = pos + 1 < plen ? a.prompts[s * a.prompt_width + pos + 1] : next;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int E, int H, int C, int V) {
  return sizeof(float) * (64 + 11 * (size_t)E + 4 * (size_t)V + (size_t)H * C + kPartial);
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.embed, a.heads, a.cache_len, a.vocab_pad);
  if (smem + kStaticSharedBytes > (size_t)kMaxSharedBytes || a.head_dim % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_generate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_generate_kernel<T><<<a.batch, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int device, const void* wte, const void* wte_t, const void* wpe, const void* ln1,
        const void* qkv_w, const void* qkv_b, const void* proj_w, const void* proj_b,
        const void* fc_w, const void* fc_b, const void* fp_w, const void* fp_b,
        const void* logits_b, const void* rel, void* kcache, void* vcache,
        const void* prompts, const void* plens, const void* temps, const void* topk,
        const void* topp, void* tokens, void* logits_out, int batch, int prompt_width,
        int layers, int heads, int head_dim, int embed, int cache_len, int window,
        int vocab_pad, int num_steps, int start_step, int out_len, int use_rel,
        unsigned seed, float softmax_scale, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args<T> a;
  a.wte = static_cast<const T*>(wte);
  a.wte_t = static_cast<const T*>(wte_t);
  a.wpe = static_cast<const T*>(wpe);
  a.ln1 = static_cast<const float*>(ln1);
  a.qkv_w = static_cast<const T*>(qkv_w);
  a.qkv_b = static_cast<const float*>(qkv_b);
  a.proj_w = static_cast<const T*>(proj_w);
  a.proj_b = static_cast<const float*>(proj_b);
  a.fc_w = static_cast<const T*>(fc_w);
  a.fc_b = static_cast<const float*>(fc_b);
  a.fp_w = static_cast<const T*>(fp_w);
  a.fp_b = static_cast<const float*>(fp_b);
  a.logits_b = static_cast<const float*>(logits_b);
  a.rel = static_cast<const T*>(rel);
  a.kcache = static_cast<T*>(kcache);
  a.vcache = static_cast<T*>(vcache);
  a.prompts = static_cast<const int*>(prompts);
  a.plens = static_cast<const int*>(plens);
  a.temps = static_cast<const float*>(temps);
  a.topk = static_cast<const float*>(topk);
  a.topp = static_cast<const float*>(topp);
  a.tokens = static_cast<int*>(tokens);
  a.logits_out = static_cast<float*>(logits_out);
  a.batch = batch;
  a.prompt_width = prompt_width;
  a.layers = layers;
  a.heads = heads;
  a.head_dim = head_dim;
  a.embed = embed;
  a.cache_len = cache_len;
  a.window = window;
  a.vocab_pad = vocab_pad;
  a.num_steps = num_steps;
  a.start_step = start_step;
  a.out_len = out_len;
  a.use_rel = use_rel;
  a.seed = seed;
  a.softmax_scale = softmax_scale;
  a.eps = eps;
  return launch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int decode_generate(
    int bf16, int device, const void* wte, const void* wte_t, const void* wpe,
    const void* ln1, const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* fc_w, const void* fc_b, const void* fp_w,
    const void* fp_b, const void* logits_b, const void* rel, void* kcache, void* vcache,
    const void* prompts, const void* plens, const void* temps, const void* topk,
    const void* topp, void* tokens, void* logits_out, int batch, int prompt_width,
    int layers, int heads, int head_dim, int embed, int cache_len, int window,
    int vocab_pad, int num_steps, int start_step, int out_len, int use_rel,
    unsigned seed, float softmax_scale, float eps, void* stream) {
  auto go = bf16 ? run<__nv_bfloat16> : run<float>;
  return go(device, wte, wte_t, wpe, ln1, qkv_w, qkv_b, proj_w, proj_b, fc_w, fc_b, fp_w,
            fp_b, logits_b, rel, kcache, vcache, prompts, plens, temps, topk, topp, tokens,
            logits_out, batch, prompt_width, layers, heads, head_dim, embed, cache_len,
            window, vocab_pad, num_steps, start_step, out_len, use_rel, seed,
            softmax_scale, eps, stream);
}
