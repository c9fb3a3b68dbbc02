// cluster_step (decode_cluster.cuh) over T rows at once: the verify block of
// the speculative kernel (spec_decode.cu), T tokens of one sequence at
// positions p0 .. p0+T-1, on the thread-block cluster of G blocks that runs
// the sequence.
//
// Row t is cluster_step at pos = key_pos = p0 + t, writing its K/V row, with
// every sum of that row taken in cluster_step's order: LayerNorm's block sums
// (rows_layer_norm), each matmul column's contiguous slices and their sums in
// order (cluster_gemv_rows: cluster_gemv's partition, set by the widths and
// the 512 threads), a (row, head)'s softmax by one warp, the AV product's
// slices of that row's own n_t = p0 + t + 1 slots. So a row's logits equal the
// sequential kernel's at that position bit for bit, in either type, whenever
// its inputs are the true stream, as an emitted row's are.
//
// What the T rows share: a matmul's (slice, unit) pairs leave most of a
// block's threads idle at G = 16 (128 of 512), so teams of threads run
// every pair for their share of the rows, each thread's unit of a weight (4
// or 16 bytes of a row) loaded once for up to two rows (kThreadRows); the
// teams load the same units close together in time, which L1 can serve
// (not measured). A score thread loads a K row once
// and dots it with every row whose position reaches it; an AV thread walks
// the union of its rows' slices (they differ by at most T - 1 slots) and
// applies each V row to the rows whose slice holds it. The exchanges, four
// cluster barriers a layer and one before sampling, carry all T rows: they
// are as many per verify block as cluster_step takes per token.
//
// Shared memory: rows_smem_floats(). The scores of T rows take T x keys
// floats a head; a block owning more heads than fit runs them in passes of
// `heads_per_pass` heads, and `rows_per_pass` (<= kRowChunk) bounds the
// matmuls' partial sums. ops/decode_kernel_spec.py::spec_cluster_passes
// picks both and mirrors the layout.

#pragma once

#include <climits>

#include "decode_cluster.cuh"

namespace decode_cluster {

constexpr int kMaxRows = 16;   // largest T (SPEC_BLOCK_MAX in ops/decode_kernel_spec.py)
constexpr int kRowChunk = 8;   // rows one pass over a weight feeds (ROW_CHUNK)
constexpr int kThreadRows = 2; // rows one thread's chain of loads feeds (pair_chains)
constexpr int kRowRed = 2 * kMaxRows * kWarps;  // rows_layer_norm's warp sums, twice

// cluster_gemv's slices of a column of a matrix with N columns, counted in
// 16-byte units of bf16 (8 columns): at least the type's own count, so the
// layout's bound on partial sums holds for float32 too.
__host__ __device__ inline int layout_splits(int N) {
  const int groups = N / 8;
  return groups >= kThreads ? 1 : kThreads / groups;
}

// Floats of cluster_gemv_rows' partial sums over `rows` rows of a matrix of
// N columns of which a block owns `cols` (none when a column is one slice).
__host__ __device__ inline size_t partial_floats(int N, int cols, int rows) {
  const int splits = layout_splits(N);
  return splits == 1 ? 0 : (size_t)rows * splits * cols;
}

// Floats of a block's dynamic shared memory: red, the id stream (keys ints),
// T rows of h, x2, attn, x1, xw, q (the block's E/G lanes), hid and logits,
// sample_row's three V rows, and one region for either the matmuls' partial
// sums or a head pass's scores (HC x T x keys) with the AV's partial sums.
// Every part is a multiple of 4 floats (16-byte shares).
__host__ __device__ inline size_t rows_smem_floats(int E, int G, int D, int keys, int V, int T,
                                                   int HC, int R) {
  size_t mm = partial_floats(3 * E, 3 * E / G, R);
  const size_t others[3] = {partial_floats(E, E / G, R), partial_floats(4 * E, 4 * E / G, R),
                            partial_floats(V, V / G, R)};
  for (size_t p : others) mm = p > mm ? p : mm;
  const size_t av = (size_t)HC * T * keys + partial_floats(E, HC * D, R);
  return kRowRed + (((size_t)keys + 3) & ~(size_t)3) + 5 * (size_t)T * E + (size_t)T * E / G +
         4 * (size_t)T * E + (size_t)T * V + 3 * (size_t)V + (av > mm ? av : mm);
}

// The buffers of cluster_rows_step in rows_smem_floats()'s layout; row t of
// a buffer of width n starts at t * n. h, x2, attn, hid and logits are the
// exchange buffers: each block's slice of every row is written by the block
// and copied into the others (share_rows).
struct RowsScratch {
  float* red;      // kRowRed floats (sample_row uses the first 64)
  int* ids;        // the id stream, keys ints
  float* h;        // T x E residual stream
  float* x2;       // T x E residual after attention
  float* attn;     // T x E attention output rounded to T
  float* x1;       // T x E ln_1 output
  float* xw;       // T x E matmul operand rounded to T
  float* q;        // T x E/G: the block's heads of q, rounded to T
  float* hid;      // T x 4E GELU output rounded to T
  float* logits;   // T x V
  float* scaled;   // V
  float* scored;   // V
  float* expv;     // V
  float* work;     // partial sums, or a head pass's scores then the AV's partial sums
  int keys;        // score row stride and id stream length
  int heads_per_pass, rows_per_pass;

  __device__ RowsScratch(float* smem, int E, int G, int keys_, int V, int T, int HC, int R)
      : keys(keys_), heads_per_pass(HC), rows_per_pass(R) {
    red = smem;
    ids = reinterpret_cast<int*>(red + kRowRed);
    h = red + kRowRed + ((keys + 3) & ~3);
    x2 = h + T * E;
    attn = x2 + T * E;
    x1 = attn + T * E;
    xw = x1 + T * E;
    q = xw + T * E;
    hid = q + T * E / G;
    logits = hid + 4 * T * E;
    scaled = logits + T * V;
    scored = scaled + V;
    expv = scored + V;
    work = expv + V;
  }
};

// layer_norm (decode_common.cuh) of `rows` rows of x, out and xw (stride n),
// each row's sums in layer_norm's order (each thread's elements in order,
// a warp butterfly, the warps' sums by one more), the rows' reductions
// sharing three block barriers.
template <typename T>
__device__ void rows_layer_norm(const float* x, float* out, float* xw, int rows, int n, float eps,
                                const float* scale, const float* bias, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const red_mean = red;
  float* const red_var = red + kMaxRows * kWarps;
  const auto total = [lane](const float* sums, int r) {
    float t = lane < kWarps ? sums[r * kWarps + lane] : 0.f;
    for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    return t;
  };
  for (int r = 0; r < rows; ++r) {
    float s = 0.f;
    for (int e = threadIdx.x; e < n; e += kThreads) s += x[r * n + e];
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red_mean[r * kWarps + warp] = s;
  }
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const float mean = total(red_mean, r) / n;
    float q = 0.f;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float c = x[r * n + e] - mean;
      q += c * c;
    }
    for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (lane == 0) red_var[r * kWarps + warp] = q;
  }
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const float mean = total(red_mean, r) / n;
    const float rs = rsqrtf(total(red_var, r) / n + eps);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      float y = (x[r * n + e] - mean) * rs;
      if (scale != nullptr) y = y * scale[e] + bias[e];
      if (out != nullptr) out[r * n + e] = y;
      xw[r * n + e] = round_to<T>(y);
    }
  }
  __syncthreads();
}

// The chains of one (slice, unit) pair of gemv_chains for NR rows r0 ..
// r0 + NR - 1 (row r's operand at x + r * ldx): each unit loaded once for
// the NR rows. With kRagged, row r0 + r sums its own slice of K = k_of(r0 +
// r) rows and the chains walk the union of the slices, applying each unit
// to the rows whose slice holds it, so every row's FMA chain is
// gemv_chains' in the same order. NR is exact (no row guards in the chain).
template <int NR, typename T, bool kv, bool kWide, bool kRagged, typename KOf, typename Out>
__device__ __forceinline__ void pair_chains(const T* col, size_t ldw, const float* x, int ldx,
                                            int r0, int part, int splits, int lc, int j, int cols,
                                            KOf k_of, Out out, float* partial) {
  using U = Unit<T, kWide>;
  // Chains of 8 units (4 of 16 bytes), not gemv_chains' 32: the verify step
  // is a long stretch of unrolled code, and shorter chains ran faster on an
  // H100 (exploratory variants; PERF.md, the speculative kernel's findings).
  constexpr int CU = U::N, kChain = kWide ? 4 : 8;
  int k0[NR], k1[NR];
  int lo = INT_MAX, hi = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int K = k_of(r0 + r);
    k0[r] = part * K / splits;
    k1[r] = (part + 1) * K / splits;
    lo = k0[r] < lo ? k0[r] : lo;
    hi = k1[r] > hi ? k1[r] : hi;
  }
  float acc[NR][CU] = {};
  for (int i0 = lo; i0 < hi; i0 += kChain) {
    typename U::type raw[kChain];
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      if (i0 + k >= hi) break;
      const auto* p = reinterpret_cast<const typename U::type*>(col + (size_t)(i0 + k) * ldw);
      raw[k] = kv ? __ldcs(p) : *p;
    }
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      const int i = i0 + k;
      if (i >= hi) break;
      float v[CU];
      U::load_f(raw[k], v);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (kRagged && (i < k0[r] || i >= k1[r])) continue;
        const float xi = x[r * ldx + i];
#pragma unroll
        for (int c = 0; c < CU; ++c) acc[r][c] = fmaf(xi, v[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int c = 0; c < CU; ++c) {
      if (splits == 1) out(r0 + r, lc + c, j + c, acc[r][c]);
      else partial[((r0 + r) * splits + part) * cols + lc + c] = acc[r][c];
    }
  }
}

// gemv_chains for `rows` rows at once: row r's operand is x_of(j) + r * ldx
// and its column sums run over rows [part K_r / splits, (part+1) K_r /
// splits) of the weight, K_r = k_of(r) (pair_chains). The (slice, unit)
// pairs leave most threads of a block of a large cluster idle (128 of 512
// at G = 16): `teams` groups of threads then run every pair, each for its
// share of the rows, kThreadRows rows a walk over the slice, loading the
// same units. The partial sums of
// row r, slice part lie at (r * splits + part) * cols.
template <typename T, bool kv, bool kWide, bool kRagged, typename ColOf, typename XOf,
          typename KOf, typename Out>
__device__ __forceinline__ void rows_chains(const T* w, size_t ldw, int cols, int splits, int rows,
                                            int ldx, ColOf col_of, XOf x_of, KOf k_of, Out out,
                                            float* partial) {
  constexpr int CU = Unit<T, kWide>::N;
  const int units = cols / CU, pairs = units * splits;
  const int teams = max(1, min(rows, kThreads / pairs)), per = (rows + teams - 1) / teams;
  for (int item = threadIdx.x; item < pairs * teams; item += kThreads) {
    const int team = item / pairs, pair = item - team * pairs;
    const int part = pair / units, lc = (pair - part * units) * CU, j = col_of(lc);
    const T* col = w + j;
    const float* x = x_of(j);
    const int end = min(rows, (team + 1) * per);
    for (int r0 = team * per; r0 < end;) {
      if (end - r0 >= kThreadRows) {
        pair_chains<kThreadRows, T, kv, kWide, kRagged>(col, ldw, x + r0 * ldx, ldx, r0, part,
                                                        splits, lc, j, cols, k_of, out, partial);
        r0 += kThreadRows;
      } else {
        pair_chains<1, T, kv, kWide, kRagged>(col, ldw, x + r0 * ldx, ldx, r0, part, splits, lc,
                                              j, cols, k_of, out, partial);
        r0 += 1;
      }
    }
  }
}

// cluster_gemv for `rows` (<= kRowChunk) rows: out(r, lc, j, y_rj) with
// cluster_gemv's partition of the N columns and each row's slices of its
// own K_r = k_of(r) (see rows_chains). Not every thread calls out, and
// nothing waits after the last call.
template <typename T, bool kWide, bool kv = false, bool kRagged = false, typename KOf,
          typename ColOf, typename XOf, typename Out>
__device__ __forceinline__ void cluster_gemv_rows(const T* w, size_t ldw, KOf k_of, int N, int cols,
                                                  int rows, int ldx, ColOf col_of, XOf x_of,
                                                  Out out, float* partial) {
  const int groups = N / Vec<T>::N;
  const int splits = groups >= kThreads ? 1 : kThreads / groups;
  rows_chains<T, kv, kWide, kRagged>(w, ldw, cols, splits, rows, ldx, col_of, x_of, k_of, out,
                                     partial);
  if (splits == 1) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, lc = idx - r * cols;
    float acc = 0.f;
#pragma unroll 8
    for (int part = 0; part < splits; ++part) acc += partial[(r * splits + part) * cols + lc];
    out(r, lc, col_of(lc), acc);
  }
}

// f(r0, rows) for the chunks of `rows_per_pass` rows of T, with a block
// barrier between chunks (they share the partial sums).
template <typename F>
__device__ __forceinline__ void row_chunks(int T, int rows_per_pass, F f) {
  for (int r0 = 0; r0 < T; r0 += rows_per_pass) {
    if (r0) __syncthreads();
    f(r0, T - r0 < rows_per_pass ? T - r0 : rows_per_pass);
  }
}

// share() for `rows` slices of n floats at base + r * stride.
__device__ __forceinline__ void share_rows(const cg::cluster_group& cluster, float* base,
                                           int stride, int n, int rows) {
  __syncthreads();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int vecs = n / 4, per_peer = vecs * rows;
  for (int t = threadIdx.x; t < per_peer * (G - 1); t += kThreads) {
    const int peer = t / per_peer, k = t - peer * per_peer, r = k / vecs, v = k - r * vecs;
    float* slice = base + (size_t)r * stride;
    const float4 value = reinterpret_cast<const float4*>(slice)[v];
    reinterpret_cast<float4*>(cluster.map_shared_rank(slice, (rank + 1 + peer) % G))[v] = value;
  }
}

// T tokens in[0, T) at positions p0 .. p0+T-1 through the model, by every
// block of the calling cluster: embedding, the pre-LN layers with each row's
// K/V written to slot p0 + t of krows / vrows (layer l's rows layer_stride
// elements on; each block writes its heads' lanes) and its attention over
// slots [0, p0 + t] with the relative bias of distance p0 + t - j, then the
// tied logits, left in sc.logits + t * V of every block. Row t computes what
// cluster_step computes at pos = key_pos = p0 + t (see the top of the file).
// clock marks the phase kinds 1-8 of PHASES in ops/decode_kernel_spec.py.
template <typename T, bool kWide>
__device__ __forceinline__ void cluster_rows_step(const Model<T> m, const RowsScratch sc,
                                                  const int* in, int p0, int nT, T* krows0,
                                                  T* vrows0, size_t layer_stride,
                                                  PhaseClock& clock) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int E = m.embed, D = m.head_dim, V = m.vocab_pad, Wn = m.window;
  const int HG = m.heads / G, EG = E / G, e0 = rank * EG, h0 = rank * HG;
  const int C = sc.keys, HC = sc.heads_per_pass, R = sc.rows_per_pass;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int VN = Vec<T>::N;
  float* const h = sc.h;
  float* const x2 = sc.x2;
  float* const attn = sc.attn;
  float* const x1 = sc.x1;
  float* const xw = sc.xw;
  float* const q = sc.q;
  float* const hid = sc.hid;
  float* const logits = sc.logits;
  float* const scores = sc.work;
  float* const partial = sc.work;
  float* const av_partial = sc.work + (size_t)HC * nT * C;
  const auto own = [=](int lc) { return e0 + lc; };  // the block's E/G lanes
  const auto width = [](int K) { return [K](int) { return K; }; };
  const auto rows_x = [](const float* x) { return [x](int) { return x; }; };

  for (int idx = tid; idx < nT * E; idx += kThreads) {
    const int t = idx / E, e = idx - t * E;
    const int pos = p0 + t, prow = pos < Wn - 1 ? pos : Wn - 1;
    h[idx] = to_f(m.wte[(size_t)in[t] * E + e]) + to_f(m.wpe[(size_t)prow * E + e]);
  }
  __syncthreads();

  for (int layer = 0; layer < m.layers; ++layer) {
    const float* ln1 = m.ln1 + (size_t)layer * 2 * E;
    rows_layer_norm<T>(h, x1, xw, nT, E, m.eps, ln1, ln1 + E, sc.red);

    // q, k, v of the block's heads for every row.
    T* krows = krows0 + layer * layer_stride;
    T* vrows = vrows0 + layer * layer_stride;
    const float* qkv_b = m.qkv_b + (size_t)layer * 3 * E;
    row_chunks(nT, R, [&](int r0, int rows) {
      cluster_gemv_rows<T, kWide>(
          m.qkv_w + (size_t)layer * E * 3 * E, 3 * E, width(E), 3 * E, 3 * EG, rows, E,
          [=](int lc) { return (lc / EG) * E + e0 + lc % EG; }, rows_x(xw + r0 * E),
          [=](int r, int, int j, float y) {
            const int t = r0 + r;
            const float v = y + qkv_b[j];
            if (j < E) q[t * EG + j - e0] = round_to<T>(v);  // q in the KV type
            else if (j < 2 * E) krows[(size_t)(p0 + t) * E + (j - E)] = from_f<T>(v);
            else vrows[(size_t)(p0 + t) * E + (j - 2 * E)] = from_f<T>(v);
          },
          partial);
    });
    __syncthreads();
    clock.mark(1);

    const T* rel = m.rel + (size_t)layer * Wn * E;
    const int slots = p0 + nT;  // the last row attends to slots [0, p0 + T - 1]
    for (int hc0 = 0; hc0 < HG; hc0 += HC) {
      // Scores of heads [hc0, hc0 + HC) for every row: one (head, slot)
      // pair per thread, its K row loaded once for the rows that reach it.
      for (int idx = tid; idx < HC * slots; idx += kThreads) {
        const int hp = idx / slots, j = idx - hp * slots, hl = hc0 + hp, hh = h0 + hl;
        const int first = j > p0 ? j - p0 : 0;  // rows t with p0 + t >= j
        const T* krow = krows + (size_t)j * E + hh * D;
        float acc[kMaxRows];
#pragma unroll
        for (int t = 0; t < kMaxRows; ++t) acc[t] = 0.f;
        for (int d = 0; d < D; d += VN) {
          const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(krow + d));
          float v[VN];
          Vec<T>::load(reinterpret_cast<const T*>(&raw), v);
#pragma unroll
          for (int t = 0; t < kMaxRows; ++t) {
            if (t >= nT) break;
            if (t < first) continue;
            float qt[VN];
#pragma unroll
            for (int c = 0; c < VN; c += 4)
              *reinterpret_cast<float4*>(qt + c) =
                  *reinterpret_cast<const float4*>(q + t * EG + hl * D + d + c);
#pragma unroll
            for (int c = 0; c < VN; ++c) acc[t] = fmaf(qt[c], v[c], acc[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < kMaxRows; ++t) {
          if (t >= nT) break;
          if (t < first) continue;
          float a = acc[t];
          if (m.use_rel) {
            // Slot j is at distance p0 + t - j: E row window-1-(p0+t-j);
            // rows outside the table give no bias. Added before scaling.
            const int r = Wn - 1 - (p0 + t - j);
            if (r >= 0) a += head_dot<T>(q + t * EG + hl * D, rel + (size_t)r * E + hh * D, D);
          }
          scores[((size_t)hp * nT + t) * C + j] = a * m.softmax_scale;
        }
      }
      __syncthreads();
      clock.mark(2);

      // Softmax per (head, row), one warp each; weights rounded to T.
      for (int item = warp; item < HC * nT; item += kWarps) {
        float* srow = scores + (size_t)item * C;
        const int n = p0 + item % nT + 1;
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
      clock.mark(3);

      // attn[t, e] = sum_j w[t, head(e), j] V[j, e] over the pass's lanes,
      // row t over its own slots [0, p0 + t].
      row_chunks(nT, R, [&](int r0, int rows) {
        cluster_gemv_rows<T, kWide, true, true>(
            vrows, E, [=](int r) { return p0 + r0 + r + 1; }, E, HC * D, rows, C,
            [=](int lc) { return e0 + hc0 * D + lc; },
            [=](int j) { return scores + ((size_t)((j - e0) / D - hc0) * nT + r0) * C; },
            [=](int r, int, int j, float y) { attn[(r0 + r) * E + j] = round_to<T>(y); },
            av_partial);
      });
      __syncthreads();
      clock.mark(4);
    }
    share_rows(cluster, attn + e0, E, EG, nT);
    cluster.sync();  // A: attn complete in every block
    clock.mark(4);

    const float* proj_b = m.proj_b + (size_t)layer * E;
    row_chunks(nT, R, [&](int r0, int rows) {
      cluster_gemv_rows<T, kWide>(
          m.proj_w + (size_t)layer * E * E, E, width(E), E, EG, rows, E, own,
          rows_x(attn + r0 * E),
          [=](int r, int, int j, float y) {
            const int i = (r0 + r) * E + j;
            x2[i] = x1[i] + (y + proj_b[j]);
          },
          partial);
    });
    share_rows(cluster, x2 + e0, E, EG, nT);
    cluster.sync();  // B: x2 complete
    clock.mark(5);

    rows_layer_norm<T>(x2, nullptr, xw, nT, E, m.eps, nullptr, nullptr, sc.red);
    const float* fc_b = m.fc_b + (size_t)layer * 4 * E;
    row_chunks(nT, R, [&](int r0, int rows) {
      cluster_gemv_rows<T, kWide>(
          m.fc_w + (size_t)layer * E * 4 * E, 4 * E, width(E), 4 * E, 4 * EG, rows, E,
          [=](int lc) { return 4 * e0 + lc; }, rows_x(xw + r0 * E),
          [=](int r, int, int j, float y) {
            hid[(r0 + r) * 4 * E + j] = round_to<T>(gelu_tanh(y + fc_b[j]));
          },
          partial);
    });
    share_rows(cluster, hid + 4 * e0, 4 * E, 4 * EG, nT);
    cluster.sync();  // C: hid complete
    clock.mark(6);

    const float* fp_b = m.fp_b + (size_t)layer * E;
    row_chunks(nT, R, [&](int r0, int rows) {
      cluster_gemv_rows<T, kWide>(
          m.fp_w + (size_t)layer * 4 * E * E, E, width(4 * E), E, EG, rows, 4 * E, own,
          rows_x(hid + r0 * 4 * E),
          [=](int r, int, int j, float y) {
            const int i = (r0 + r) * E + j;
            h[i] = (x2[i] + y) + fp_b[j];
          },
          partial);
    });
    share_rows(cluster, h + e0, E, EG, nT);
    cluster.sync();  // D: h complete
    clock.mark(7);
  }

  // Tied logits: standardize(h) @ wte_t + logits_b, V/G columns a block.
  rows_layer_norm<T>(h, nullptr, xw, nT, E, m.eps, nullptr, nullptr, sc.red);
  const int VG = V / G;
  const float* logits_b = m.logits_b;
  row_chunks(nT, R, [&](int r0, int rows) {
    cluster_gemv_rows<T, kWide>(
        m.wte_t, V, width(E), V, VG, rows, E, [=](int lc) { return rank * VG + lc; },
        rows_x(xw + r0 * E),
        [=](int r, int, int j, float y) { logits[(r0 + r) * V + j] = y + logits_b[j]; },
        partial);
  });
  share_rows(cluster, logits + rank * VG, V, VG, nT);
  cluster.sync();  // E: logits complete
  clock.mark(8);
}

}  // namespace decode_cluster
