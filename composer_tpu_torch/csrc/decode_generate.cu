// decode_generate: the whole autoregressive generation loop of the Music
// Transformer in one kernel launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels composer_tpu/ops/decode_kernel_batched.py
// (_batched_kernel, B > 1) and composer_tpu/ops/decode_kernel.py
// (_decode_kernel, B = 1). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_batched.py::decode_generate_reference.
//
// One thread block per sequence; the block loops over every step, and each
// step runs decode_step (decode_common.cuh, shared with decode_segment.cu):
// embedding, pre-LN layers (ln_2 and ln_f folded into the weights at pack
// time), KV append, attention with the Music-Transformer relative bias,
// tied logits, temperature, top-k / top-p, Gumbel-max with a counter-based
// Philox4x32-10; the kernel feeds the token back. Weights are read from L2
// every step (about 12.6 MB per block per step in bf16 for the default
// model); only B of the 132 SMs are busy. The H x C float32 scores live in shared memory,
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

// Static shared memory (s_token) beside the dynamic buffer; both count
// against kMaxSharedBytes (STATIC_SHARED_BYTES in decode_kernel_batched.py).
constexpr int kStaticSharedBytes = static_shared_bytes(sizeof(int));

template <typename T>
struct Args {
  Model<T> m;          // packed weights and widths
  T* kcache;           // (L, B*C, E)
  T* vcache;           // (L, B*C, E)
  const int* prompts;  // (B, P)
  const int* plens;    // (B,)
  const float* temps;  // (B,)
  const float* topk;   // (B,), Vpad+1 = off
  const float* topp;   // (B,), 2.0 = off
  int* tokens;         // (B, out_len)
  float* logits_out;   // (B, Vpad) last step's logits, or null
  int batch, prompt_width, cache_len;
  int num_steps, start_step, out_len;
  unsigned seed;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_generate_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_token;
  const int E = a.m.embed, C = a.cache_len, V = a.m.vocab_pad;
  const int s = blockIdx.x, tid = threadIdx.x;
  const StepScratch scratch(smem, E, a.m.heads, C, V);
  T* krows = a.kcache + (size_t)s * C * E;
  T* vrows = a.vcache + (size_t)s * C * E;
  const size_t layer_stride = (size_t)a.batch * C * E;

  const float temp = a.temps[s];
  const int plen = a.plens[s];
  const float topk = a.topk[s], topp = a.topp[s];
  if (tid == 0) s_token = a.prompts[s * a.prompt_width + a.start_step];
  __syncthreads();

  for (int pos = a.start_step; pos < a.num_steps; ++pos) {
    float* logits_out = a.logits_out != nullptr && pos == a.num_steps - 1
                            ? a.logits_out + (size_t)s * V : nullptr;
    const int next = decode_step<T>(a.m, scratch, s_token, pos, pos, true, krows, vrows,
                                    layer_stride, temp, topk, topp, a.seed, (unsigned)pos,
                                    (unsigned)s, logits_out);
    if (tid == 0) {
      const int col = pos - plen + 1;
      if (col >= 0 && col < a.out_len) a.tokens[(size_t)s * a.out_len + col] = next;
      s_token = pos + 1 < plen ? a.prompts[s * a.prompt_width + pos + 1] : next;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * step_smem_floats(a.m.embed, a.m.heads, a.cache_len,
                                                       a.m.vocab_pad);
  if (smem + kStaticSharedBytes > (size_t)kMaxSharedBytes || a.m.head_dim % 8 != 0)
    return (int)cudaErrorInvalidValue;
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
  a.m = Model<T>{static_cast<const T*>(wte), static_cast<const T*>(wte_t),
                 static_cast<const T*>(wpe), static_cast<const float*>(ln1),
                 static_cast<const T*>(qkv_w), static_cast<const float*>(qkv_b),
                 static_cast<const T*>(proj_w), static_cast<const float*>(proj_b),
                 static_cast<const T*>(fc_w), static_cast<const float*>(fc_b),
                 static_cast<const T*>(fp_w), static_cast<const float*>(fp_b),
                 static_cast<const float*>(logits_b), static_cast<const T*>(rel),
                 layers, heads, head_dim, embed, window, vocab_pad, use_rel,
                 softmax_scale, eps};
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
  a.cache_len = cache_len;
  a.num_steps = num_steps;
  a.start_step = start_step;
  a.out_len = out_len;
  a.seed = seed;
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
