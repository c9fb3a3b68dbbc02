// decode_segment: `steps` decode steps of a batch of serving slots, for
// NVIDIA Hopper (sm_90a): continuous batching.
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_segmented.py
// (_segment_kernel). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_segmented.py::decode_segment_reference.
//
// The serving loop runs in segments of a fixed step count; the KV cache and
// the carry (each slot's next input token) stay on the card between
// launches, so the scheduler can evict finished rows and admit new ones at
// every segment boundary. Slot s runs global steps [step0, step0 + steps)
// at position i - starts[s]: teacher-forced while inside its prompt, fed
// back its own sample after. A negative position is parked (starts =
// PARKED = 2**30 marks an empty slot): it emits -1 and writes nothing.
//
// Design: one thread-block cluster per slot, as in decode_generate.cu, running
// the same one-token step body (cluster_step in decode_cluster.cuh) at the
// same cluster size for the same batch (ops/decode_kernel_batched.py::
// cluster_size), so a slot's ids equal decode_generate's bit for bit in either
// type; the step's sums do not depend on the cluster size, so neither do the
// ids. It replaced one thread block per slot, which read every weight through
// one SM a step. Each cluster has its own position, so per-row positions cost
// nothing: the per-row position embedding, relative-bias alignment and
// causal bound the TPU kernel paid for by replicating rows are the step's own
// arguments here. A cluster parked for the whole segment exits at once: all
// its blocks read the same starts[s], so they leave together, before any
// block writes into another's shared memory. `live` bounds the cache rows
// attention reads: a row whose position reaches it attends to [0, live) and
// writes nothing, so a finished row that lingers one segment (admission lags
// eviction by one) can never write past its slot into the next one. The
// Gumbel noise is Philox keyed by (seed, slot, global step i, lane), so a
// row's samples do not depend on how the loop is cut into segments nor on
// when other rows were admitted.
//
// What bounds it on the H100: as decode_generate, each cluster's weight reads
// from L2 (12.6/G MB of bf16 per block and step) and its slot's K/V prefix,
// and the latency of the step's barriers. The (H/G) x live float32 scores
// live in shared memory (ops/decode_kernel_segmented.py::segment_kernel_fits
// admits by the one-block budget).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry points: decode_segment(...), returns the launch's cudaError_t;
// decode_segment_clusters(...), the clusters of G blocks that can be resident
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
  T* kcache;           // (L, B*C, E), carried between segments
  T* vcache;           // (L, B*C, E)
  int* carry;          // (B,) next input token per slot, carried
  const int* prompts;  // (B, P)
  const int* plens;    // (B,) in [1, P]
  const int* starts;   // (B,) global step of position 0; PARKED = empty
  const float* temps;  // (B,)
  const float* topk;   // (B,), Vpad+1 = off
  const float* topp;   // (B,), 2.0 = off
  int* tokens;         // (B, steps)
  int batch, prompt_width, cache_len, step0, steps, live;
  unsigned seed;
};

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) decode_segment_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_token;
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int E = a.m.embed, C = a.cache_len, P = a.prompt_width;
  const int s = blockIdx.x / G, tid = threadIdx.x;
  const bool rank0 = cluster.block_rank() == 0;
  const int start = a.starts[s];
  const int plen = min(max(a.plens[s], 1), P);
  const int* prompt = a.prompts + (size_t)s * P;
  int* out = a.tokens + (size_t)s * a.steps;
  // The first step of this segment at which the row is active.
  const long long lead = (long long)start - a.step0;
  const int first = lead <= 0 ? 0 : (lead >= a.steps ? a.steps : (int)lead);
  if (rank0)
    for (int j = tid; j < first; j += kThreads) out[j] = -1;
  if (first == a.steps) {
    // Parked through the whole segment: its next input is its prompt's
    // first token (position < 0 clamps into the prompt).
    if (rank0 && tid == 0) a.carry[s] = prompt[0];
    return;
  }

  const ClusterScratch scratch(smem, E, a.m.heads / G, a.live, a.m.vocab_pad);
  T* krows = a.kcache + (size_t)s * C * E;
  T* vrows = a.vcache + (size_t)s * C * E;
  const size_t layer_stride = (size_t)a.batch * C * E;
  const float temp = a.temps[s], topk = a.topk[s], topp = a.topp[s];
  if (tid == 0) {
    // The input of the first active step: the row's own prompt while the
    // position is inside it (a slot admitted at this boundary must not read
    // the previous occupant's carry), else the carried sample.
    const int pos = a.step0 + first - start;
    s_token = pos < plen ? prompt[pos] : a.carry[s];
  }
  // Every block of the cluster runs before any block writes into its
  // shared memory.
  cluster.sync();

  for (int j = first; j < a.steps; ++j) {
    const int i = a.step0 + j;
    const int pos = i - start;
    const int key_pos = pos < a.live ? pos : a.live - 1;
    const int next = cluster_step<T, kWide>(a.m, scratch, s_token, pos, key_pos, pos < a.live,
                                            krows, vrows, layer_stride, temp, topk, topp,
                                            a.seed, (unsigned)i, (unsigned)s, nullptr);
    if (tid == 0) {
      if (rank0) out[j] = next;
      s_token = pos + 1 < plen ? prompt[pos + 1] : next;
    }
    __syncthreads();
  }
  // Every block has read the carry before rank 0 overwrites it, and no block
  // leaves while a peer may still write into its shared memory.
  cluster.sync();
  if (rank0 && tid == 0) a.carry[s] = s_token;
}

template <typename T>
int launch(const Args<T>& a, int cluster, cudaStream_t stream) {
  if (!cluster_takes(cluster, a.m.embed, a.m.heads, a.m.head_dim, a.live, a.m.vocab_pad,
                     kStaticSharedBytes) ||
      a.live < 1 || a.live > a.cache_len || a.steps < 1)
    return (int)cudaErrorInvalidValue;
  return cluster_launch(wide_units<T>(cluster, a.m.embed) ? decode_segment_kernel<T, true>
                                                           : decode_segment_kernel<T, false>,
                        cluster, a.batch, a.m.embed, a.m.heads,
                        a.live, a.m.vocab_pad, stream, a);
}

template <typename T>
int run(int device, const void* wte, const void* wte_t, const void* wpe, const void* ln1,
        const void* qkv_w, const void* qkv_b, const void* proj_w, const void* proj_b,
        const void* fc_w, const void* fc_b, const void* fp_w, const void* fp_b,
        const void* logits_b, const void* rel, void* kcache, void* vcache, void* carry,
        const void* prompts, const void* plens, const void* starts, const void* temps,
        const void* topk, const void* topp, void* tokens, int batch, int prompt_width,
        int layers, int heads, int head_dim, int embed, int cache_len, int window,
        int vocab_pad, int step0, int steps, int live, int use_rel, unsigned seed,
        float softmax_scale, float eps, int cluster, void* stream) {
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
  a.carry = static_cast<int*>(carry);
  a.prompts = static_cast<const int*>(prompts);
  a.plens = static_cast<const int*>(plens);
  a.starts = static_cast<const int*>(starts);
  a.temps = static_cast<const float*>(temps);
  a.topk = static_cast<const float*>(topk);
  a.topp = static_cast<const float*>(topp);
  a.tokens = static_cast<int*>(tokens);
  a.batch = batch;
  a.prompt_width = prompt_width;
  a.cache_len = cache_len;
  a.step0 = step0;
  a.steps = steps;
  a.live = live;
  a.seed = seed;
  return launch<T>(a, cluster, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int decode_segment(
    int bf16, int device, const void* wte, const void* wte_t, const void* wpe,
    const void* ln1, const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* fc_w, const void* fc_b, const void* fp_w,
    const void* fp_b, const void* logits_b, const void* rel, void* kcache, void* vcache,
    void* carry, const void* prompts, const void* plens, const void* starts,
    const void* temps, const void* topk, const void* topp, void* tokens, int batch,
    int prompt_width, int layers, int heads, int head_dim, int embed, int cache_len,
    int window, int vocab_pad, int step0, int steps, int live, int use_rel, unsigned seed,
    float softmax_scale, float eps, int cluster, void* stream) {
  auto go = bf16 ? run<__nv_bfloat16> : run<float>;
  return go(device, wte, wte_t, wpe, ln1, qkv_w, qkv_b, proj_w, proj_b, fc_w, fc_b, fp_w,
            fp_b, logits_b, rel, kcache, vcache, carry, prompts, plens, starts, temps, topk,
            topp, tokens, batch, prompt_width, layers, heads, head_dim, embed, cache_len,
            window, vocab_pad, step0, steps, live, use_rel, seed, softmax_scale, eps, cluster,
            stream);
}

extern "C" int decode_segment_clusters(int bf16, int device, int cluster, int embed, int heads,
                                       int head_dim, int keys, int vocab_pad, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!cluster_takes(cluster, embed, heads, head_dim, keys, vocab_pad, kStaticSharedBytes))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return cluster_occupancy(wide_units<__nv_bfloat16>(cluster, embed)
                                 ? decode_segment_kernel<__nv_bfloat16, true>
                                 : decode_segment_kernel<__nv_bfloat16, false>,
                             cluster, embed, heads, keys, vocab_pad, count);
  return cluster_occupancy(wide_units<float>(cluster, embed) ? decode_segment_kernel<float, true>
                                                             : decode_segment_kernel<float, false>,
                           cluster, embed, heads, keys, vocab_pad, count);
}
