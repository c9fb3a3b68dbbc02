// The one-token step body of the resident decode kernels (decode_generate.cu
// and decode_segment.cu), spread over a thread-block cluster: one cluster of
// G blocks per sequence, on G SMs of one GPC, exchanging activations through
// distributed shared memory.
//
// Block g of a cluster (its rank) owns heads [g H/G, (g+1) H/G), the same
// E/G lanes of q, k, v and of the attention output, and a 1/G slice of every
// matmul's output columns. Per layer:
//   ln_1             every block, on the full residual row in its own shared
//                    memory (no exchange);
//   qkv              its 3 E/G columns; the K/V append to its heads' lanes of
//                    the cache row; scores, softmax and the AV product over
//                    its heads;
//   share attn       its E/G lanes copied into every block's attn; barrier A;
//   proj, residual   its E/G columns, copied into every block's x2; barrier B;
//   ln_2, fc, GELU   ln_2 in every block; its 4E/G columns, copied into every
//                    block's hid; barrier C;
//   fp, residual     its E/G columns, copied into every block's h; barrier D.
// Per step: ln_f and its V/G columns of the tied logits, copied into every
// block's logits row; barrier E; then every block samples the same row
// (sample_row in decode_common.cuh, the same Philox bits as the other decode
// kernels) and so draws the same token, with no broadcast.
//
// A block writes its slice of an exchange buffer in its own shared memory,
// then copies it into the same buffer of every other block of the cluster
// (share: 16-byte stores through map_shared_rank, spread over the block's
// threads); the barrier that follows (barrier.cluster arrive.release /
// wait.acquire, cg cluster.sync) makes the copies visible. Each exchange has
// its own buffer, read only until the block arrives at the next barrier, and
// the next copy into it comes at least one barrier later, so no buffer is
// written while a peer still reads it.
//
// The arithmetic is the one-block kernel's, step for step: every sum is
// taken in the order that kernel took it, an order fixed by the model's
// widths and the block's 512 threads alone (cluster_gemv: each column's rows
// in contiguous slices, the slices' sums in order; layer_norm's block sums;
// a head's softmax by one warp). So the ids equal that kernel's bit for bit,
// in either type, and a row's ids do not depend on its batch, whose size sets
// G. G = 1 is the one-block layout in the same code.
//
// What bounds it on the H100: the weights (about 12.6 MB of bf16 for the
// default model) are read from L2 by every cluster each step, 12.6/G MB per
// block, so B x G SMs share the reads that one SM per sequence made before;
// at B = 8 the clusters' reads meet the L2's bandwidth, and each row's K/V
// prefix (H/G heads per block) streams from HBM, marked evict-first. The
// rest is latency: four cluster barriers and about fifteen block barriers a
// layer, one more cluster barrier a step, and the matmuls' chains of row
// loads (up to 64 rows a chain for the default model, 32 or 8 in flight).

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "decode_common.cuh"

namespace decode_cluster {

namespace cg = cooperative_groups;
using namespace decode_common;

constexpr int kMaxCluster = 16;  // CLUSTER_SIZES[0] in ops/decode_kernel_batched.py
// The slices' sums of cluster_gemv: splits x columns is at most kThreads x
// Vec<T>::N, 8 for bf16.
constexpr int kPartial = kThreads * 8;

// The packed weights (ops/decode_kernel.py::pack_weights) and the model's
// widths, as cluster_step reads them.
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

// The shared-memory budget both kernels admit a cache by, in floats, for a
// score row of `keys` slots per head: the one-block layout's, which the
// cluster layout at G = 1 stays within (cluster_smem_floats: E floats fewer).
// kernel_smem_bytes() in ops/decode_kernel_batched.py mirrors it, so the
// caches admitted (and the routing that follows them) do not change.
__host__ __device__ inline size_t budget_floats(int E, int H, int keys, int V) {
  return 64 + 11 * (size_t)E + 4 * (size_t)V + (size_t)H * keys + kPartial;
}

// Floats of dynamic shared memory a block of a cluster uses when it owns
// `heads` heads (H / G).
__host__ __device__ inline size_t cluster_smem_floats(int E, int heads, int keys, int V) {
  return 64 + 10 * (size_t)E + 4 * (size_t)V + (size_t)heads * keys + kPartial;
}

// The scratch buffers of cluster_step, carved out of a block's dynamic
// shared memory in cluster_smem_floats()'s layout. h, x2, attn, hid and
// logits are the exchange buffers: full rows, each block's slice written by
// the block and copied into the others (share).
struct ClusterScratch {
  float* red;      // 64 floats (also 16 doubles)
  float* h;        // residual stream, E (slices from fp; the embedding)
  float* x2;       // residual after attention, E (slices from proj)
  float* attn;     // attention output rounded to T, E (slices from AV)
  float* x1;       // ln_1 output, E
  float* xw;       // matmul operand rounded to T, E
  float* q;        // the block's heads of q, rounded to T (E / G of E)
  float* hid;      // GELU output rounded to T, 4E (slices from fc)
  float* logits;   // V (slices from the tied logits)
  float* scaled;   // V
  float* scored;   // V
  float* expv;     // V
  float* scores;   // (H / G) x keys
  float* partial;  // kPartial
  int keys;        // score row stride: the most slots a step attends to

  __device__ ClusterScratch(float* smem, int E, int heads, int keys_, int V) : keys(keys_) {
    red = smem;
    h = red + 64;
    x2 = h + E;
    attn = x2 + E;
    x1 = attn + E;
    xw = x1 + E;
    q = xw + E;
    hid = q + E;
    logits = hid + 4 * E;
    scaled = logits + V;
    scored = scaled + V;
    expv = scored + V;
    scores = expv + V;
    partial = scores + (size_t)heads * keys;
  }
};

// q_h . row[0, D) of a K cache row, D a multiple of Vec<T>::N: head_dot
// with its 16-byte loads marked evict-first (ld.global.cs), as are the V
// rows' in cluster_gemv. Each row's prefix streams past the weights once a
// layer and step, and at B = 8 the 64 MB cache would otherwise push the
// weights out of L2: B=8, 64 steps from position 960 took 0.90x the time of
// the default policy on an H100 (scripts/decode_kv_policy.py, PERF.md).
template <typename T>
__device__ __forceinline__ float kv_dot(const float* q, const T* row, int D) {
  constexpr int VN = Vec<T>::N;
  float acc = 0.f;
  for (int d = 0; d < D; d += VN) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(row + d));
    float v[VN];
    Vec<T>::load(reinterpret_cast<const T*>(&raw), v);
#pragma unroll
    for (int c = 0; c < VN; ++c) acc = fmaf(q[d + c], v[c], acc);
  }
  return acc;
}

// 4 or (kWide) 16 bytes of a row: the columns one chain of cluster_gemv
// covers, and the rows whose loads a chain has in flight at once (128 bytes
// of registers).
template <typename T, bool kWide>
struct Unit {
  using type = typename std::conditional<kWide, uint4, unsigned>::type;
  static constexpr int N = sizeof(type) / sizeof(T);
  static constexpr int kChain = 128 / sizeof(type);
  static __device__ __forceinline__ void load_f(const type& r, float* out) {
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = to_f(t[c]);
  }
};

// Whether the kernels run cluster_gemv over 16-byte units (else 4-byte
// ones) at cluster size G: where the narrowest matmul (E columns, E rows)
// still gives at least half of a block's threads a chain in 16-byte units.
// For the default model that is G <= 2; wider clusters' blocks own too few
// columns for that and take four times the chains over the same rows. A
// kernel template parameter, so each instantiation holds one form (both in
// one kernel cost it spilled registers).
template <typename T>
__host__ __device__ inline bool wide_units(int G, int E) {
  const int groups = E / Vec<T>::N;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  return E / G / Vec<T>::N * splits >= kThreads / 2;
}

// cluster_gemv's chains over units of Unit<T, kWide>; see there.
template <typename T, bool kv, bool kWide, typename ColOf, typename XOf, typename Out>
__device__ __forceinline__ void gemv_chains(const T* w, size_t ldw, int K, int cols, int splits,
                                            ColOf col_of, XOf x_of, Out out, float* partial) {
  using U = Unit<T, kWide>;
  constexpr int CU = U::N, kChain = U::kChain;
  const int units = cols / CU;
  for (int item = threadIdx.x; item < units * splits; item += kThreads) {
    const int part = item / units, lc = (item - part * units) * CU, j = col_of(lc);
    const int k0 = part * K / splits, k1 = (part + 1) * K / splits;
    const T* col = w + j;
    const float* x = x_of(j);
    float acc[CU] = {};
    for (int i0 = k0; i0 < k1; i0 += kChain) {
      typename U::type r[kChain];
#pragma unroll
      for (int k = 0; k < kChain; ++k) {
        if (i0 + k >= k1) break;
        const auto* p = reinterpret_cast<const typename U::type*>(col + (size_t)(i0 + k) * ldw);
        r[k] = kv ? __ldcs(p) : *p;
      }
#pragma unroll
      for (int k = 0; k < kChain; ++k) {
        if (i0 + k >= k1) break;
        float v[CU];
        U::load_f(r[k], v);
#pragma unroll
        for (int c = 0; c < CU; ++c) acc[c] = fmaf(x[i0 + k], v[c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CU; ++c) {
      if (splits == 1) out(lc + c, j + c, acc[c]);
      else partial[part * cols + lc + c] = acc[c];
    }
  }
}

// out(lc, j, y_j) for the block's `cols` columns lc (global column j =
// col_of(lc); runs of Vec<T>::N consecutive local columns are consecutive
// columns) of a row-major weight w with row stride ldw: y_j = sum_i
// x_of(j)[i] w[i, j] over i < K, x in shared memory (already rounded to T),
// w the V cache when kv (kv_dot's policy). The sum is the one-block
// kernel's, whatever the columns per block, so the ids equal that kernel's
// bit for bit and do not depend on G: the whole matrix's N columns form
// N / Vec<T>::N groups, each column's rows are cut into splits = max(1,
// kThreads / groups) contiguous slices, each an FMA chain in row order, and
// the slices' sums are added in order from 0. A thread runs the chains of a
// unit of columns (16 bytes of a row if kWide, else 4; wide_units) over a slice, a
// chain's worth of rows' loads at a time; the sums of several slices meet in
// `partial`. Not every thread calls out, and nothing waits after the last
// call: the caller synchronises before reading what out wrote or calling
// cluster_gemv again.
template <typename T, bool kWide, bool kv = false, typename ColOf, typename XOf,
          typename Out>
__device__ __forceinline__ void cluster_gemv(const T* w, size_t ldw, int K, int N, int cols,
                                             ColOf col_of, XOf x_of, Out out, float* partial) {
  const int groups = N / Vec<T>::N;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  gemv_chains<T, kv, kWide>(w, ldw, K, cols, splits, col_of, x_of, out, partial);
  if (splits == 1) return;
  __syncthreads();
  for (int lc = threadIdx.x; lc < cols; lc += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int part = 0; part < splits; ++part) acc += partial[part * cols + lc];
    out(lc, col_of(lc), acc);
  }
}

// Copies the block's slice[0, n) (n a multiple of 4, 16-byte aligned) to
// the same place in every other block of the cluster: 16 bytes a store,
// spread over the block's threads, each block starting at its next rank.
// Starts with __syncthreads, so the slice is complete; the cluster barrier
// that follows makes the copies visible.
__device__ __forceinline__ void share(const cg::cluster_group& cluster, float* slice, int n) {
  __syncthreads();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int vecs = n / 4;
  for (int t = threadIdx.x; t < vecs * (G - 1); t += kThreads) {
    const int r = t / vecs, k = t - r * vecs;
    const float4 v = reinterpret_cast<const float4*>(slice)[k];
    reinterpret_cast<float4*>(cluster.map_shared_rank(slice, (rank + 1 + r) % G))[k] = v;
  }
}

// One token of one sequence through the model, then its sample, by every
// block of the calling cluster: embedding (wte[token] + wpe[min(pos, W-1)]),
// the pre-LN layers with the KV append and attention over cache slots
// [0, key_pos] (with the relative bias of distance key_pos - j), tied
// logits, then sample_row with Philox counter (step, row). The K/V of this
// token go to slot key_pos of krows / vrows (the sequence's rows of layer 0;
// layer l's are layer_stride elements on), each block writing its heads'
// lanes, when `write`; otherwise nothing is written. logits_out, when not
// null, receives the logits (from rank 0). Every thread of every block of
// the cluster returns the same token.
//
// m and sc are taken by value: with references to the kernel's parameter
// struct, ptxas held the bf16 one-block kernels at 64 registers, and
// decode_generate took 1.38x (B=8) and 1.17x (B=1) the time it takes by
// value (PERF.md).
template <typename T, bool kWide>
__device__ __forceinline__ int cluster_step(const Model<T> m, const ClusterScratch sc, int token,
                                            int pos, int key_pos, bool write, T* krows0,
                                            T* vrows0, size_t layer_stride, float temp,
                                            float topk, float topp, unsigned seed,
                                            unsigned step, unsigned row, float* logits_out) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int E = m.embed, D = m.head_dim, V = m.vocab_pad, Wn = m.window;
  const int HG = m.heads / G, EG = E / G, e0 = rank * EG, h0 = rank * HG;
  const int C = sc.keys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* const h = sc.h;
  float* const x2 = sc.x2;
  float* const attn = sc.attn;
  float* const x1 = sc.x1;
  float* const xw = sc.xw;
  float* const q = sc.q;
  float* const hid = sc.hid;
  float* const logits = sc.logits;
  float* const scores = sc.scores;
  float* const partial = sc.partial;
  const auto own = [=](int lc) { return e0 + lc; };  // the block's E/G lanes
  const auto row_x = [](const float* x) { return [x](int) { return x; }; };

  const int prow = pos < Wn - 1 ? pos : Wn - 1;
  for (int e = tid; e < E; e += kThreads)
    h[e] = to_f(m.wte[(size_t)token * E + e]) + to_f(m.wpe[(size_t)prow * E + e]);
  __syncthreads();

  for (int layer = 0; layer < m.layers; ++layer) {
    const float* ln1 = m.ln1 + (size_t)layer * 2 * E;
    layer_norm<T>(h, x1, xw, E, m.eps, ln1, ln1 + E, sc.red);

    // q, k, v of the block's heads: local column lc of section lc / EG.
    T* krows = krows0 + layer * layer_stride;
    T* vrows = vrows0 + layer * layer_stride;
    const float* qkv_b = m.qkv_b + (size_t)layer * 3 * E;
    cluster_gemv<T, kWide>(
        m.qkv_w + (size_t)layer * E * 3 * E, 3 * E, E, 3 * E, 3 * EG,
        [=](int lc) { return (lc / EG) * E + e0 + lc % EG; }, row_x(xw),
        [=](int, int j, float y) {
          const float v = y + qkv_b[j];
          if (j < E) q[j - e0] = round_to<T>(v);  // q in the KV type
          else if (!write) return;
          else if (j < 2 * E) krows[(size_t)key_pos * E + (j - E)] = from_f<T>(v);
          else vrows[(size_t)key_pos * E + (j - 2 * E)] = from_f<T>(v);
        },
        partial);
    __syncthreads();

    // Scores of the block's heads for slots [0, key_pos]: one (head, slot)
    // pair per thread, slots of one head on adjacent threads.
    const int n = key_pos + 1;
    const T* rel = m.rel + (size_t)layer * Wn * E;
#pragma unroll 4
    for (int idx = tid; idx < HG * n; idx += kThreads) {
      const int hl = idx / n, j = idx - hl * n, hh = h0 + hl;
      const float* qh = q + hl * D;
      float acc = kv_dot<T>(qh, krows + (size_t)j * E + hh * D, D);
      if (m.use_rel) {
        // Slot j is at distance key_pos - j: E row window-1-(key_pos-j);
        // rows outside the table give no bias. Added before scaling.
        const int r = Wn - 1 - (key_pos - j);
        if (r >= 0) acc += head_dot<T>(qh, rel + (size_t)r * E + hh * D, D);
      }
      scores[hl * C + j] = acc * m.softmax_scale;
    }
    __syncthreads();

    // Softmax per head, one warp per head; weights rounded to T.
    for (int hl = warp; hl < HG; hl += kWarps) {
      float* srow = scores + hl * C;
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

    // attn[e] = sum_j w[head(e), j] * V[j, e] over the block's lanes: a
    // matmul with the slots as K; shared with every block.
    cluster_gemv<T, kWide, true>(
        vrows, E, n, E, EG, own, [=](int j) { return scores + ((j - e0) / D) * C; },
        [=](int, int j, float y) { attn[j] = round_to<T>(y); }, partial);
    share(cluster, attn + e0, EG);
    cluster.sync();  // A: attn complete in every block

    const float* proj_b = m.proj_b + (size_t)layer * E;
    cluster_gemv<T, kWide>(
        m.proj_w + (size_t)layer * E * E, E, E, E, EG, own, row_x(attn),
        [=](int, int j, float y) { x2[j] = x1[j] + (y + proj_b[j]); }, partial);
    share(cluster, x2 + e0, EG);
    cluster.sync();  // B: x2 complete

    layer_norm<T>(x2, nullptr, xw, E, m.eps, nullptr, nullptr, sc.red);
    const float* fc_b = m.fc_b + (size_t)layer * 4 * E;
    cluster_gemv<T, kWide>(
        m.fc_w + (size_t)layer * E * 4 * E, 4 * E, E, 4 * E, 4 * EG,
        [=](int lc) { return 4 * e0 + lc; }, row_x(xw),
        [=](int, int j, float y) { hid[j] = round_to<T>(gelu_tanh(y + fc_b[j])); }, partial);
    share(cluster, hid + 4 * e0, 4 * EG);
    cluster.sync();  // C: hid complete

    const float* fp_b = m.fp_b + (size_t)layer * E;
    cluster_gemv<T, kWide>(
        m.fp_w + (size_t)layer * 4 * E * E, E, 4 * E, E, EG, own, row_x(hid),
        [=](int, int j, float y) { h[j] = (x2[j] + y) + fp_b[j]; }, partial);
    share(cluster, h + e0, EG);
    cluster.sync();  // D: h complete
  }

  // Tied logits: standardize(h) @ wte_t + logits_b, V/G columns a block.
  layer_norm<T>(h, nullptr, xw, E, m.eps, nullptr, nullptr, sc.red);
  const int VG = V / G;
  const float* logits_b = m.logits_b;
  cluster_gemv<T, kWide>(
      m.wte_t, V, E, V, VG, [=](int lc) { return rank * VG + lc; }, row_x(xw),
      [=](int, int j, float y) { logits[j] = y + logits_b[j]; }, partial);
  share(cluster, logits + rank * VG, VG);
  cluster.sync();  // E: logits complete
  if (logits_out != nullptr && rank == 0)
    for (int v = tid; v < V; v += kThreads) logits_out[v] = logits[v];

  return sample_row(logits, sc.scaled, sc.scored, sc.expv, V, temp, topk, topp, seed, step, row,
                    sc.red);
}

// Host side of a launch of `batch` clusters of `cluster` blocks each.

// Whether a kernel running cluster_step takes these widths at cluster size
// G: the budget (with the kernel's static shared bytes) within the card's
// shared memory, G dividing H and the logits' columns, head_dim a multiple
// of 8 (16-byte loads of a head's lanes).
inline bool cluster_takes(int G, int E, int H, int D, int keys, int V, int static_bytes) {
  return G >= 1 && G <= kMaxCluster && H % G == 0 && D % 8 == 0 && V % (8 * G) == 0 &&
         sizeof(float) * budget_floats(E, H, keys, V) + static_bytes <= (size_t)kMaxSharedBytes;
}

// The launch configuration (grid, block, `smem` bytes of dynamic shared
// memory a block, cluster dimension) in cfg and attr; sets the kernel's
// attributes for it and returns the error of doing so.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int cluster, int batch, size_t smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // Clusters of more than 8 blocks are outside the portable limit.
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Launches kernel(args) as `batch` clusters of `cluster` blocks with `smem`
// bytes of dynamic shared memory a block on stream; returns the launch's
// error.
template <typename Kernel, typename Args>
int cluster_launch(Kernel kernel, int cluster, int batch, size_t smem, cudaStream_t stream,
                   const Args& args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, cluster, batch, smem, stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cluster_launch with cluster_step's layout: a block owning H/G heads.
template <typename Kernel, typename Args>
int cluster_launch(Kernel kernel, int cluster, int batch, int E, int H, int keys, int V,
                   cudaStream_t stream, const Args& args) {
  return cluster_launch(kernel, cluster, batch,
                        sizeof(float) * cluster_smem_floats(E, H / cluster, keys, V), stream,
                        args);
}

// The count of clusters of `cluster` blocks of kernel, with `smem` bytes
// of dynamic shared memory a block, that can be resident at once
// (cudaOccupancyMaxActiveClusters) in *count; returns the error.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int cluster, size_t smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, cluster, 1, smem, nullptr, &cfg, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(count, (void*)kernel, &cfg);
  return (int)err;
}

// cluster_occupancy with cluster_step's layout.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int cluster, int E, int H, int keys, int V, int* count) {
  return cluster_occupancy(kernel, cluster,
                           sizeof(float) * cluster_smem_floats(E, H / cluster, keys, V), count);
}

}  // namespace decode_cluster
