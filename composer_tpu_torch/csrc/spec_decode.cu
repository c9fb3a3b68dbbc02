// spec_decode: batch-1 speculative decoding of the Music Transformer in one
// kernel launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_spec.py
// (_spec_decode_kernel). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_spec.py::speculative_generate_reference.
//
// One thread-block cluster of G blocks runs the whole generation (G from
// ops/decode_kernel_batched.py::cluster_size at batch 1, as decode_generate
// takes it: 16 for the default model on an H100), a loop over verify blocks
// of T positions starting at p0. Each verify block, in every block of the
// cluster:
//   1. drafts T-1 tokens: the latest j in [1, p0-(T-1)] whose 2-gram
//      (ids[j-1], ids[j]) equals (ids[p0-1], ids[p0]), else whose 1-gram
//      ids[j] equals ids[p0], else j = 0; input t is ids[p0+t] inside the
//      prompt or at t = 0, ids[j+t] after it;
//   2. runs the T rows through the model (cluster_rows_step,
//      decode_cluster_rows.cuh): row t is decode_generate's step
//      (cluster_step) at position p0+t, its K and V written to slot p0+t;
//   3. samples the rows in order, as the sequential kernel samples position
//      p0+t (sample_row with the Philox bits of row 0, step p0+t), and stops
//      at the first row whose sample differs from the next drafted input;
//   4. emits the accepted prefix (1 to T tokens) and moves p0 past it.
// Every block keeps the id stream in its own shared memory and computes the
// same draft and samples, so all leave the loop together with no broadcast;
// rank 0 writes the ids. stats = [blocks, generation blocks, final p0, 0...].
// The optional clock (phase_ns in the wrapper) times each phase kind of a
// verify block (PHASES in ops/decode_kernel_spec.py) in rank 0.
//
// Numerics: an emitted row's inputs are the true stream and its sums are
// taken in cluster_step's order, so its logits equal decode_generate's at
// that position bit for bit, in float32 and bfloat16: greedy and sampled
// ids equal decode_generate's at batch 1. (Matmul operands rounded to the
// weight type, float32 accumulation; q and the softmax weights rounded to
// the weight type; no tensor cores, whose sums take another order.)
//
// What bounds it on the H100: the step is decode_generate's, a latency chain
// of about 17 phases a layer on G SMs with the weights (12.6 MB of bf16 for
// the default model) read from L2, 12.6/G MB a block; a verify block runs
// that chain once for T rows, loading each weight unit and each K and V row
// once for all of them, so it costs one step's loads and barriers plus T
// rows of FMAs. What decides its speed against decode_generate is the
// acceptance (tokens per verify block) over the block's cost in steps.
// Keys past p0+t are never read, so stale rows of rejected drafts and
// uninitialised scratch never enter a product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry points: spec_decode(...), returns the launch's cudaError_t;
// spec_decode_clusters(...), the clusters of G blocks that can be resident at
// once (cudaOccupancyMaxActiveClusters).

#include "decode_cluster_rows.cuh"

namespace {

using namespace decode_common;
using namespace decode_cluster;

// The block's static shared state, beside the dynamic buffer
// rows_smem_floats() sizes; both count against kMaxSharedBytes
// (SPEC_STATIC_SHARED_BYTES in decode_kernel_spec.py).
struct BlockState {
  int in[kMaxRows];    // the verify block's input tokens
  int samp[kMaxRows];  // its samples
  int go;              // 1 while the samples match the drafts
};
constexpr int kStaticSharedBytes = static_shared_bytes(sizeof(BlockState));
static_assert(kStaticSharedBytes == 144, "mirrored in Python");

template <typename T>
struct Args {
  Model<T> m;          // packed weights and widths
  T* kcache;           // (L, C, E), C = cache_rows
  T* vcache;           // (L, C, E)
  const int* prompt;   // (plen,)
  int* out;            // (length + 8,): tokens, then stats
  unsigned long long* clock;  // (kPhases,) ns per phase kind, or null
  int plen, cache_rows, length, block, heads_per_pass, rows_per_pass;
  unsigned seed;
  float temp, topk, topp;
};

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) spec_decode_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ BlockState st;
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const bool rank0 = cluster.block_rank() == 0;
  const int E = a.m.embed, C = a.cache_rows, V = a.m.vocab_pad, nT = a.block, plen = a.plen;
  const int tid = threadIdx.x;
  const RowsScratch sc(smem, E, G, C, V, nT, a.heads_per_pass, a.rows_per_pass);
  int* const ids = sc.ids;
  int* const red = reinterpret_cast<int*>(sc.red);
  PhaseClock clock(a.clock);

  for (int i = tid; i < C; i += kThreads) ids[i] = i < plen ? a.prompt[i] : 0;
  // Every block of the cluster runs before any block writes into its
  // shared memory (and the id stream is complete).
  cluster.sync();

  // Every thread of every block keeps the same copy of the loop state.
  int p0 = 0, blocks = 0, gen_blocks = 0;
  const int end = plen - 1 + a.length;
  while (p0 < end) {
    // --- Draft: the latest earlier occurrence of the context tail. ---------
    const int last1 = ids[p0], last2 = p0 >= 1 ? ids[p0 - 1] : 0;
    int best1 = -1, best2 = -1;
    for (int c = 1 + tid; c <= p0 - (nT - 1); c += kThreads) {
      if (ids[c] == last1) {
        best1 = c;
        if (ids[c - 1] == last2) best2 = c;
      }
    }
    best1 = block_max_int(best1, red);
    best2 = block_max_int(best2, red + kWarps);
    const int j = best2 >= 0 ? best2 : (best1 >= 0 ? best1 : 0);
    if (tid < nT) st.in[tid] = (p0 + tid < plen || tid == 0) ? ids[p0 + tid] : ids[j + tid];
    __syncthreads();
    // Accepted inputs are the true stream; rejected ones are overwritten
    // before any later read.
    if (tid < nT) ids[p0 + tid] = st.in[tid];
    clock.mark(0);

    // --- The T rows through the model; logits in every block. --------------
    cluster_rows_step<T, kWide>(a.m, sc, st.in, p0, nT, a.kcache, a.vcache, (size_t)C * E,
                                clock);

    // --- Sample the rows in order; stop at the first mismatch. -------------
    // Row t matches when it has a successor in the block that is a prompt
    // token (forced) or equals its sample; n_emit = 1 + leading matches.
    int n_emit = nT;
    for (int t = 0; t < nT; ++t) {
      const int s = sample_row(sc.logits + t * V, sc.scaled, sc.scored, sc.expv, V, a.temp,
                               a.topk, a.topp, a.seed, (unsigned)(p0 + t), 0u, sc.red);
      if (tid == 0) {
        st.samp[t] = s;
        st.go = t < nT - 1 && (p0 + t + 1 < plen || s == st.in[t + 1]);
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
      for (int t = 0; rank0 && t < n_emit; ++t) {
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
    clock.mark(9);
  }
  if (rank0 && tid < 8) {
    const int stats[3] = {blocks, gen_blocks, p0};
    a.out[a.length + tid] = tid < 3 ? stats[tid] : 0;
  }
  // No block leaves while a peer may still write into its shared memory.
  cluster.sync();
}

// Whether the kernel takes these widths at cluster size G with head passes
// of HC heads and row passes of R rows: G dividing H and the logits'
// columns, HC dividing H / G, head_dim a multiple of 8 (16-byte loads of a
// head's lanes), and the layout within the card's shared memory.
bool spec_takes(int G, int E, int H, int D, int keys, int V, int T, int HC, int R) {
  return G >= 1 && G <= kMaxCluster && H % G == 0 && D % 8 == 0 && V % (8 * G) == 0 &&
         T >= 2 && T <= kMaxRows && HC >= 1 && (H / G) % HC == 0 && R >= 1 &&
         R <= kRowChunk &&
         sizeof(float) * rows_smem_floats(E, G, D, keys, V, T, HC, R) + kStaticSharedBytes <=
             (size_t)kMaxSharedBytes;
}

template <typename T>
auto kernel_for(int G, int E) {
  return wide_units<T>(G, E) ? spec_decode_kernel<T, true> : spec_decode_kernel<T, false>;
}

template <typename T>
int launch(const Args<T>& a, int cluster, cudaStream_t stream) {
  const Model<T>& m = a.m;
  if (!spec_takes(cluster, m.embed, m.heads, m.head_dim, a.cache_rows, m.vocab_pad, a.block,
                  a.heads_per_pass, a.rows_per_pass) ||
      a.plen < 1 || a.plen - 1 + a.length + a.block > a.cache_rows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * rows_smem_floats(m.embed, cluster, m.head_dim, a.cache_rows,
                                                       m.vocab_pad, a.block, a.heads_per_pass,
                                                       a.rows_per_pass);
  return cluster_launch(kernel_for<T>(cluster, m.embed), cluster, 1, smem, stream, a);
}

template <typename T>
int run(int device, const void* const* ptrs, const int* ints, unsigned seed,
        const float* floats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args<T> a;
  a.m = Model<T>{static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
                 static_cast<const T*>(ptrs[2]), static_cast<const float*>(ptrs[3]),
                 static_cast<const T*>(ptrs[4]), static_cast<const float*>(ptrs[5]),
                 static_cast<const T*>(ptrs[6]), static_cast<const float*>(ptrs[7]),
                 static_cast<const T*>(ptrs[8]), static_cast<const float*>(ptrs[9]),
                 static_cast<const T*>(ptrs[10]), static_cast<const float*>(ptrs[11]),
                 static_cast<const float*>(ptrs[12]), static_cast<const T*>(ptrs[13]),
                 ints[1], ints[2], ints[3], ints[4], ints[6], ints[7], ints[10],
                 floats[3], floats[4]};
  a.kcache = static_cast<T*>(const_cast<void*>(ptrs[14]));
  a.vcache = static_cast<T*>(const_cast<void*>(ptrs[15]));
  a.prompt = static_cast<const int*>(ptrs[16]);
  a.out = static_cast<int*>(const_cast<void*>(ptrs[17]));
  a.clock = static_cast<unsigned long long*>(const_cast<void*>(ptrs[18]));
  a.plen = ints[0];
  a.cache_rows = ints[5];
  a.length = ints[8];
  a.block = ints[9];
  a.heads_per_pass = ints[12];
  a.rows_per_pass = ints[13];
  a.seed = seed;
  a.temp = floats[0];
  a.topk = floats[1];
  a.topp = floats[2];
  return launch<T>(a, ints[11], static_cast<cudaStream_t>(stream));
}

template <typename T>
int occupancy(int G, int E, int H, int D, int keys, int V, int T_, int HC, int R, int* count) {
  if (!spec_takes(G, E, H, D, keys, V, T_, HC, R)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy(kernel_for<T>(G, E), G,
                           sizeof(float) * rows_smem_floats(E, G, D, keys, V, T_, HC, R), count);
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
    int cluster, int heads_per_pass, int rows_per_pass, void* clock, void* stream) {
  const void* ptrs[19] = {wte, wte_t, wpe, ln1, qkv_w, qkv_b, proj_w, proj_b, fc_w,
                          fc_b, fp_w, fp_b, logits_b, rel, kcache, vcache, prompt, out, clock};
  const int ints[14] = {plen, layers, heads, head_dim, embed, cache_rows, window,
                        vocab_pad, length, block, use_rel, cluster, heads_per_pass,
                        rows_per_pass};
  const float floats[5] = {temp, topk, topp, softmax_scale, eps};
  auto go = bf16 ? run<__nv_bfloat16> : run<float>;
  return go(device, ptrs, ints, seed, floats, stream);
}

extern "C" int spec_decode_clusters(int bf16, int device, int cluster, int embed, int heads,
                                    int head_dim, int keys, int vocab_pad, int block,
                                    int heads_per_pass, int rows_per_pass, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto query = bf16 ? occupancy<__nv_bfloat16> : occupancy<float>;
  return query(cluster, embed, heads, head_dim, keys, vocab_pad, block, heads_per_pass,
               rows_per_pass, count);
}
