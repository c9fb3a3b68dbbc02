// decode_wide_segment: `steps` decode steps of a batch of serving slots with
// the weights streamed from HBM, for NVIDIA Hopper (sm_90a): continuous
// batching for models whose weights outgrow the card's fast memory.
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_wide_segmented.py
// (_wide_segment_kernel). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_wide_segmented.py::
// decode_segment_wide_reference.
//
// It is decode_wide.cu with per-row clocks, as decode_segment.cu is
// decode_generate.cu's step body with per-row clocks. Slot s runs global
// steps [step0, step0 + steps) at position i - starts[s]: teacher-forced
// while inside its prompt, fed back its own sample after. A negative position
// is parked (starts = PARKED = 2**30 marks an empty slot): it emits -1 and
// writes nothing. The K/V cache (L, 2, B, C, E) and the carry (each slot's
// next input token) stay on the card between launches, so the scheduler can
// evict and admit at every segment boundary.
//
// What bounds it: HBM bytes, as decode_wide. At embed 1024 the packed
// weights are about 200 MB of bf16, four times the 50 MB L2, so every step
// streams them from HBM, plus each live row's K/V prefix. One cooperative
// launch per segment, one persistent block per SM, grid barriers between the
// phases of a layer (decode_wide.cu's P1-P7), and in every matmul phase each
// weight byte is read once per step for all live rows (gemv_phase in
// decode_wide_common.cuh).
//
// What the per-row clocks change against decode_wide:
//   * at every step each block lists the active slots (position >= 0) in
//     slot order; the phases run on those rows only, so a parked slot costs
//     nothing and a step with none is skipped by every block alike;
//   * each row has its own position embedding row, its own K/V write (row
//     pos, only while pos < live) and its own key count min(pos, live-1) + 1,
//     with the relative band aligned to min(pos, live-1): a row whose position
//     reaches `live` attends to [0, live) and writes nothing, so a finished
//     row that lingers one segment cannot write into the next slot's rows;
//   * the (row, head, key split) attention items take each row's own split
//     count (at least 64 keys a split), so no split is empty and the merge
//     never meets a split without keys;
//   * the sample of slot s at global step i draws the Philox noise of
//     (seed, s, i), decode_segment's key: a row's stream does not depend on
//     how the loop is cut into segments nor on when other rows were admitted.
//
// Numerics as decode_wide: matmul inputs rounded to the activation type A,
// float32 sums, an int8 weight's column scale on the sum; q rounded to A,
// scores, softmax and the AV sum in float32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: decode_wide_segment(...), returns the launch's cudaError_t.

#include <cooperative_groups.h>

#include "decode_wide_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace decode_common;
using namespace decode_wide_common;

// Ints of the per-step row list at the front of the dynamic shared memory
// (STEP_INFO_BYTES in ops/decode_kernel_wide_segmented.py): the number of
// active rows, and per row its slot, position, split count and first item.
constexpr int kStepInfo = 64;

template <typename W, typename A>
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
  A* kv;                   // (L, 2, B, C, E), carried between segments
  int* carry;              // (B,) next input token per slot, carried
  const int* prompts;      // (B, P)
  const int* plens;        // (B,) in [1, P]
  const int* starts;       // (B,) global step of position 0; PARKED = empty
  const float* temps;      // (B,)
  const float* topk;       // (B,), Vpad+1 = off
  const float* topp;       // (B,), 2.0 = off
  int* tokens;             // (B, steps)
  unsigned long long* clock;  // (7,) ns per phase kind, or null
  // Scratch, in scratch_floats()'s order, indexed by active row.
  float* x1;               // (B, E) ln_1 output (the residual's base)
  float* q;                // (B, E) q rounded to A
  float* x2;               // (B, E)
  float* h;                // (B, E) residual stream
  float* hid;              // (B, 4E) GELU output rounded to A
  float* logits;           // (B, Vpad)
  float* part;             // (B, H, kMaxSplits, D + 2): acc[D], max, sum
  int* token;              // (B,) each slot's next input, by slot
  int batch, prompt_width, layers, heads, head_dim, embed, cache_len, window, vocab_pad;
  int step0, steps, live, use_rel;
  unsigned seed;
  float softmax_scale, eps;
};

template <typename W, typename A>
__global__ void __launch_bounds__(kThreads, 1)
    decode_wide_segment_kernel(const Args<W, A> a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int slots = a.batch, E = a.embed, H = a.heads, D = a.head_dim, V = a.vocab_pad;
  const int C = a.cache_len, Wn = a.window, L = a.layers, P = a.prompt_width;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* const info = reinterpret_cast<int*>(smem);  // kStepInfo
  int* const row_slot = info + 1;                   // kMaxBatch each
  int* const row_pos = row_slot + kMaxBatch;
  int* const row_splits = row_pos + kMaxBatch;
  int* const row_item0 = row_splits + kMaxBatch;    // kMaxBatch + 1
  float* const red = smem + kStepInfo;              // 64
  float* const gred = red + 64;                     // kWarps * 4 * kMaxBatch
  float* const rows = gred + kWarps * 4 * kMaxBatch;  // slots * E
  float* const xs = rows + (size_t)slots * E;       // union
  const bool quantized = a.wscale != nullptr;
  constexpr int VA = Vec<A>::N;  // K/V elements per 16-byte load

  if (blockIdx.x == 0) {
    // The input of each slot's first step in this segment: its own prompt
    // while the position is inside it (a slot admitted at this boundary must
    // not read the previous occupant's carry; a parked position clamps to
    // the prompt's first token), else the carried sample. And -1 for the
    // steps a slot is parked.
    if (tid < slots) {
      const int plen = min(max(a.plens[tid], 1), P);
      const long long pos0 = (long long)a.step0 - a.starts[tid];
      a.token[tid] = pos0 < plen ? a.prompts[tid * P + (pos0 < 0 ? 0 : (int)pos0)] : a.carry[tid];
    }
    for (int t = tid; t < slots * a.steps; t += kThreads) {
      const int s = t / a.steps, j = t - s * a.steps;
      if ((long long)a.step0 + j < a.starts[s]) a.tokens[t] = -1;
    }
  }
  grid.sync();
  PhaseClock clock(a.clock);
  auto sync = [&](int phase) {
    grid.sync();
    clock.mark(phase);
  };

  for (int j = 0; j < a.steps; ++j) {
    const int i = a.step0 + j;
    // The step's active rows in slot order, the same list in every block.
    if (tid == 0) {
      int B = 0;
      for (int s = 0; s < slots; ++s) {
        const long long pos = (long long)i - a.starts[s];
        if (pos >= 0) {
          row_slot[B] = s;
          row_pos[B] = (int)pos;
          ++B;
        }
      }
      // Key splits per (row, head): enough items to cover the grid, at least
      // 64 keys each (so none is empty).
      int cap = B > 0 ? (int)gridDim.x / (B * H) : 1;
      cap = cap < 1 ? 1 : (cap > kMaxSplits ? kMaxSplits : cap);
      row_item0[0] = 0;
      for (int r = 0; r < B; ++r) {
        const int keys = min(row_pos[r], a.live - 1) + 1;
        const int S = min((keys + 63) / 64, cap);
        row_splits[r] = S;
        row_item0[r + 1] = row_item0[r] + H * S;
      }
      info[0] = B;
    }
    __syncthreads();
    const int B = info[0];
    const int items = row_item0[B];
    __syncthreads();  // thread 0 rewrites the list at the next step
    if (B == 0) continue;  // every block skips the same steps

    for (int layer = 0; layer < L; ++layer) {
      const W* big = a.big_w + (size_t)layer * 8 * E * E;
      const float* wsc = quantized ? a.wscale + (size_t)layer * 8 * E : nullptr;

      // P1: ln_1 and the qkv columns; k, v to the cache at row pos.
      if (layer == 0) {
#pragma unroll 2
        for (int x = tid * VA; x < B * E; x += kThreads * VA) {
          const int b = x / E, e = x - b * E;
          const int pos = row_pos[b];
          float t[VA], p[VA];
          Load<A, VA>::ro(a.wte + (size_t)__ldcg(a.token + row_slot[b]) * E + e, t);
          Load<A, VA>::ro(a.wpe + (size_t)(pos < Wn - 1 ? pos : Wn - 1) * E + e, p);
#pragma unroll
          for (int c = 0; c < VA; ++c) rows[x + c] = t[c] + p[c];
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
        gemv_phase<W>(xs, big, E, 3 * E, B, gred, [&](int b, int col, float y) {
          const float v = (wsc != nullptr ? y * wsc[col] : y) + bias[col];
          if (col < E) {
            a.q[b * E + col] = round_to<A>(v);
            return;
          }
          const int pos = row_pos[b];
          if (pos >= a.live) return;  // a lingering row writes nothing
          const int which = col < 2 * E ? 0 : 1, e = col - E - which * E;
          const size_t line = ((size_t)layer * 2 + which) * slots + row_slot[b];
          a.kv[(line * C + pos) * E + e] = from_f<A>(v);
        });
      }
      sync(0);

      // P2: attention, (row, head, key split) items over the blocks.
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int b = 0;
        while (item >= row_item0[b + 1]) ++b;
        const int S = row_splits[b], local = item - row_item0[b];
        const int hh = local / S, s = local - hh * S;
        const int key_pos = min(row_pos[b], a.live - 1), n = key_pos + 1;
        const int per = (n + S - 1) / S;
        const int j0 = s * per, j1 = min(n, j0 + per);
        float* const qh = xs;
        float* const sc = xs + D;
        float* const av = sc + a.live;
        for (int d = tid; d < D; d += kThreads) qh[d] = __ldcg(a.q + b * E + hh * D + d);
        __syncthreads();
        const size_t kline = (size_t)layer * 2 * slots + row_slot[b], vline = kline + slots;
        // Scores: D / VA lanes per key, each loading VA lanes of the key's
        // head (and of its band row) with one vector load; several keys per
        // warp and round, so each thread keeps several loads in flight.
        {
          const int lanes = D / VA, keys = 32 / lanes, g = lane % lanes;
          const float* qg = qh + g * VA;
#pragma unroll 4
          for (int base = j0 + warp * keys; base < j1; base += kWarps * keys) {
            const int jj = base + lane / lanes;
            float part = 0.f, v[VA];
            if (jj < j1) {
              Load<A, VA>::cg(a.kv + (kline * C + jj) * E + hh * D + g * VA, v);
#pragma unroll
              for (int c = 0; c < VA; ++c) part = fmaf(qg[c], v[c], part);
              // Slot jj is at distance key_pos - jj: table row
              // window-1-(key_pos-jj); rows outside the table give no bias.
              const int r = Wn - 1 - (key_pos - jj);
              if (a.use_rel && r >= 0) {
                Load<A, VA>::ro(a.rel + ((size_t)layer * Wn + r) * E + hh * D + g * VA, v);
#pragma unroll
                for (int c = 0; c < VA; ++c) part = fmaf(qg[c], v[c], part);
              }
            }
            for (int o = lanes / 2; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            if (jj < j1 && g == 0) sc[jj - j0] = part * a.softmax_scale;
          }
        }
        __syncthreads();
        float mx = -CUDART_INF_F;
        for (int k = tid; k < j1 - j0; k += kThreads) mx = fmaxf(mx, sc[k]);
        mx = block_max(mx, red);
        float local_sum = 0.f;
        for (int k = tid; k < j1 - j0; k += kThreads) {
          const float p = expf(sc[k] - mx);
          sc[k] = p;
          local_sum += p;
        }
        const float sum = block_sum(local_sum, red);
        // acc[d] = sum_j p_j v_j[d]: thread (group of VA lanes, slice) over
        // every slices-th key, one vector load a key.
        const int groups = D / VA, slices = kThreads / groups;
        const int g = tid % groups, slice = tid / groups;
        float acc[VA] = {};
#pragma unroll 4
        for (int jj = j0 + slice; jj < j1; jj += slices) {
          const float p = sc[jj - j0];
          float vv[VA];
          Load<A, VA>::cg(a.kv + (vline * C + jj) * E + hh * D + g * VA, vv);
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
      merge_splits<A>(a.part, xs, xs + (size_t)B * E, B, H, D, E,
                      [&](int b) { return row_splits[b]; });
      {
        const float* bias = a.proj_b + (size_t)layer * E;
        gemv_phase<W>(xs, big + (size_t)3 * E * E, E, E, B, gred, [&](int b, int col, float y) {
          const float v = (wsc != nullptr ? y * wsc[3 * E + col] : y) + bias[col];
          a.x2[b * E + col] = __ldcg(a.x1 + b * E + col) + v;
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
                      [&](int b, int col, float y) {
          const float v = (wsc != nullptr ? y * wsc[4 * E + col] : y) + bias[col];
          a.hid[(size_t)b * 4 * E + col] = round_to<A>(gelu_tanh(v));
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
                      [&](int b, int col, float y) {
          const float v = fsc != nullptr ? y * fsc[col] : y;
          a.h[b * E + col] = (__ldcg(a.x2 + b * E + col) + v) + bias[col];
        });
      }
      sync(4);
    }

    // P6: tied logits, standardize(h) @ logits_w + logits_b.
    copy_cg(rows, a.h, B * E);
    __syncthreads();
    rows_layer_norm<A>(rows, nullptr, xs, B, E, a.eps, nullptr, nullptr, red);
    gemv_phase<A>(xs, a.logits_w, E, V, B, gred, [&](int b, int col, float y) {
      a.logits[(size_t)b * V + col] = y + a.logits_b[col];
    });
    sync(5);

    // P7: a block per active row samples it with the noise of (seed, slot,
    // global step i) and feeds the next input back.
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const int slot = row_slot[b], pos = row_pos[b];
      float* const lg = xs;
      for (int v = tid; v < V; v += kThreads) lg[v] = __ldcg(a.logits + (size_t)b * V + v);
      __syncthreads();
      const int next = sample_row(lg, lg + V, lg + 2 * V, lg + 3 * V, V, a.temps[slot],
                                  a.topk[slot], a.topp[slot], a.seed, (unsigned)i,
                                  (unsigned)slot, red);
      if (tid == 0) {
        const int plen = min(max(a.plens[slot], 1), P);
        a.tokens[(size_t)slot * a.steps + j] = next;
        a.token[slot] = pos + 1 < plen ? a.prompts[slot * P + pos + 1] : next;
      }
      __syncthreads();
    }
    sync(6);
  }
  if (blockIdx.x == 0 && tid < slots) a.carry[tid] = __ldcg(a.token + tid);
}

template <typename W, typename A>
int launch(Args<W, A>& a, int device, int grid, cudaStream_t stream) {
  auto kernel = decode_wide_segment_kernel<W, A>;
  const size_t smem = sizeof(float) * (kStepInfo + smem_floats(a.batch, a.embed, a.head_dim,
                                                               a.live, a.vocab_pad));
  if (smem > (size_t)kMaxSharedBytes || a.batch < 1 || a.batch > kMaxBatch ||
      a.embed % 16 != 0 || a.head_dim % 8 != 0 || a.head_dim > 128 ||
      kThreads % a.head_dim != 0 || a.live < 1 || a.live > a.cache_len || a.steps < 1)
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
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W, typename A>
int run(int device, int grid, const void* const* p, int scratch_size, const int* dims,
        unsigned seed, float softmax_scale, float eps, void* stream) {
  Args<W, A> a;
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
  a.carry = static_cast<int*>(const_cast<void*>(p[15]));
  a.prompts = static_cast<const int*>(p[16]);
  a.plens = static_cast<const int*>(p[17]);
  a.starts = static_cast<const int*>(p[18]);
  a.temps = static_cast<const float*>(p[19]);
  a.topk = static_cast<const float*>(p[20]);
  a.topp = static_cast<const float*>(p[21]);
  a.tokens = static_cast<int*>(const_cast<void*>(p[22]));
  float* scratch = static_cast<float*>(const_cast<void*>(p[23]));
  a.clock = static_cast<unsigned long long*>(const_cast<void*>(p[24]));
  a.batch = dims[0];
  a.prompt_width = dims[1];
  a.layers = dims[2];
  a.heads = dims[3];
  a.head_dim = dims[4];
  a.embed = dims[5];
  a.cache_len = dims[6];
  a.window = dims[7];
  a.vocab_pad = dims[8];
  a.step0 = dims[9];
  a.steps = dims[10];
  a.live = dims[11];
  a.use_rel = dims[12];
  a.seed = seed;
  a.softmax_scale = softmax_scale;
  a.eps = eps;
  const int B = a.batch, E = a.embed;
  if ((size_t)scratch_size < scratch_floats(B, E, a.heads, a.head_dim, a.vocab_pad))
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
  return launch<W, A>(a, device, grid, static_cast<cudaStream_t>(stream));
}

}  // namespace

// weight_kind: 0 float32, 1 bfloat16, 2 int8 (bf16 tables, activations and
// K/V). Pointers in the order of
// ops/decode_kernel_wide_segmented.py::decode_segment_wide; wscale and
// fpscale are null for float weights, clock when it is off.
extern "C" int decode_wide_segment(
    int weight_kind, int device, int grid, const void* big_w, const void* fp_w,
    const void* wscale, const void* fpscale, const void* wte, const void* logits_w,
    const void* wpe, const void* ln1, const void* qkv_b, const void* proj_b, const void* fc_b,
    const void* fp_b, const void* logits_b, const void* rel, void* kv, void* carry,
    const void* prompts, const void* plens, const void* starts, const void* temps,
    const void* topk, const void* topp, void* tokens, void* scratch, void* clock,
    int scratch_size, int batch, int prompt_width, int layers, int heads, int head_dim,
    int embed, int cache_len, int window, int vocab_pad, int step0, int steps, int live,
    int use_rel, unsigned seed, float softmax_scale, float eps, void* stream) {
  const void* p[] = {big_w, fp_w, wscale, fpscale, wte, logits_w, wpe, ln1, qkv_b,
                     proj_b, fc_b, fp_b, logits_b, rel, kv, carry, prompts, plens,
                     starts, temps, topk, topp, tokens, scratch, clock};
  const int dims[] = {batch, prompt_width, layers, heads, head_dim, embed, cache_len,
                      window, vocab_pad, step0, steps, live, use_rel};
  using bf16 = __nv_bfloat16;
  switch (weight_kind) {
    case 0: return run<float, float>(device, grid, p, scratch_size, dims, seed, softmax_scale,
                                     eps, stream);
    case 1: return run<bf16, bf16>(device, grid, p, scratch_size, dims, seed, softmax_scale,
                                   eps, stream);
    case 2: return run<int8_t, bf16>(device, grid, p, scratch_size, dims, seed, softmax_scale,
                                     eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
