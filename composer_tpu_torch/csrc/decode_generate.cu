// decode_generate: the whole autoregressive generation loop of the Music
// Transformer in one kernel launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels composer_tpu/ops/decode_kernel_batched.py
// (_batched_kernel, B > 1) and composer_tpu/ops/decode_kernel.py
// (_decode_kernel, B = 1). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_batched.py::decode_generate_reference.
//
// Design: one thread-block cluster per sequence, G blocks of 512 threads on
// G SMs of one GPC (G = ops/decode_kernel_batched.py::cluster_size: the
// largest power of two <= 16 that divides H, with batch x G <= the SM count
// and every cluster resident at once; 1 past 66 sequences, the one-block
// layout in the same code). It replaced one block per sequence, which read
// all weights (12.6 MB of bf16 for the default model) through one SM each
// step while only B of the 132 SMs worked. The cluster loops over every
// step, and each step runs cluster_step (decode_cluster.cuh, shared with
// decode_segment.cu): embedding, pre-LN layers (ln_2 and ln_f folded into
// the weights at pack time), KV append, attention with the Music-Transformer
// relative bias, tied logits, temperature, top-k / top-p, Gumbel-max with a
// counter-based Philox4x32-10; each block owns H/G heads and a 1/G slice of
// every matmul's columns, and the blocks exchange activations through
// distributed shared memory at four cluster barriers a layer and one a
// step. Every
// block samples the same token and feeds it back; rank 0 writes the ids.
//
// What bounds it on the H100: each cluster reads the weights from L2 every
// step, 12.6/G MB per block, and each row's K/V prefix from HBM; at B = 8 the
// clusters' weight reads meet the L2's bandwidth, at B = 1 the step's latency
// chain (barriers and L2 round trips) holds it. The (H/G) x C float32 scores
// live in shared memory; caches are admitted by the one-block layout's
// budget (ops/decode_kernel_batched.py::kernel_fits), which every G fits.
//
// Numerics: matmul operands are rounded to the weight type T and accumulated
// in float32; q is rounded to the KV type (T) before the scores, the softmax
// weights to T before the AV product. The nucleus mass is summed in double.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry points: decode_generate(...), returns the launch's cudaError_t;
// decode_generate_clusters(...), the clusters of G blocks that can be resident
// at once (cudaOccupancyMaxActiveClusters).

#include "decode_cluster.cuh"

namespace {

using namespace decode_common;
using namespace decode_cluster;

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

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) decode_generate_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_token;
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int E = a.m.embed, C = a.cache_len, V = a.m.vocab_pad;
  const int s = blockIdx.x / G, tid = threadIdx.x;
  const bool rank0 = cluster.block_rank() == 0;
  const ClusterScratch scratch(smem, E, a.m.heads / G, C, V);
  T* krows = a.kcache + (size_t)s * C * E;
  T* vrows = a.vcache + (size_t)s * C * E;
  const size_t layer_stride = (size_t)a.batch * C * E;

  const float temp = a.temps[s];
  const int plen = a.plens[s];
  const float topk = a.topk[s], topp = a.topp[s];
  if (tid == 0) s_token = a.prompts[s * a.prompt_width + a.start_step];
  // Every block of the cluster runs before any block writes into its
  // shared memory.
  cluster.sync();

  for (int pos = a.start_step; pos < a.num_steps; ++pos) {
    float* logits_out = a.logits_out != nullptr && pos == a.num_steps - 1
                            ? a.logits_out + (size_t)s * V : nullptr;
    const int next = cluster_step<T, kWide>(a.m, scratch, s_token, pos, pos, true, krows,
                                            vrows, layer_stride, temp, topk, topp, a.seed,
                                            (unsigned)pos, (unsigned)s, logits_out);
    if (tid == 0) {
      const int col = pos - plen + 1;
      if (rank0 && col >= 0 && col < a.out_len) a.tokens[(size_t)s * a.out_len + col] = next;
      s_token = pos + 1 < plen ? a.prompts[s * a.prompt_width + pos + 1] : next;
    }
    __syncthreads();
  }
  // No block leaves while a peer may still write into its shared memory.
  cluster.sync();
}

template <typename T>
int launch(const Args<T>& a, int cluster, cudaStream_t stream) {
  if (!cluster_takes(cluster, a.m.embed, a.m.heads, a.m.head_dim, a.cache_len, a.m.vocab_pad,
                     kStaticSharedBytes))
    return (int)cudaErrorInvalidValue;
  return cluster_launch(wide_units<T>(cluster, a.m.embed) ? decode_generate_kernel<T, true>
                                                           : decode_generate_kernel<T, false>,
                        cluster, a.batch, a.m.embed, a.m.heads,
                        a.cache_len, a.m.vocab_pad, stream, a);
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
        unsigned seed, float softmax_scale, float eps, int cluster, void* stream) {
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
  return launch<T>(a, cluster, static_cast<cudaStream_t>(stream));
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
    unsigned seed, float softmax_scale, float eps, int cluster, void* stream) {
  auto go = bf16 ? run<__nv_bfloat16> : run<float>;
  return go(device, wte, wte_t, wpe, ln1, qkv_w, qkv_b, proj_w, proj_b, fc_w, fc_b, fp_w,
            fp_b, logits_b, rel, kcache, vcache, prompts, plens, temps, topk, topp, tokens,
            logits_out, batch, prompt_width, layers, heads, head_dim, embed, cache_len,
            window, vocab_pad, num_steps, start_step, out_len, use_rel, seed,
            softmax_scale, eps, cluster, stream);
}

extern "C" int decode_generate_clusters(int bf16, int device, int cluster, int embed, int heads,
                                        int head_dim, int keys, int vocab_pad, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!cluster_takes(cluster, embed, heads, head_dim, keys, vocab_pad, kStaticSharedBytes))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return cluster_occupancy(wide_units<__nv_bfloat16>(cluster, embed)
                                 ? decode_generate_kernel<__nv_bfloat16, true>
                                 : decode_generate_kernel<__nv_bfloat16, false>,
                             cluster, embed, heads, keys, vocab_pad, count);
  return cluster_occupancy(wide_units<float>(cluster, embed) ? decode_generate_kernel<float, true>
                                                             : decode_generate_kernel<float, false>,
                           cluster, embed, heads, keys, vocab_pad, count);
}
