// decode_wide_segment: `steps` decode steps of a batch of serving slots with
// the weights streamed from HBM, for NVIDIA Hopper (sm_90a): continuous
// batching for models whose weights outgrow the card's fast memory.
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_wide_segmented.py
// (_wide_segment_kernel). Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_wide_segmented.py::
// decode_segment_wide_reference.
//
// It runs decode_wide.cu's step body (wide_step in decode_wide_common.cuh,
// where the phases, the weight stream, the barriers and the numerics are
// described) with per-row clocks, as decode_segment.cu runs
// decode_generate.cu's. Slot s runs global steps [step0, step0 + steps) at
// position i - starts[s]: teacher-forced while inside its prompt, fed back
// its own sample after. A negative position is parked (starts = PARKED =
// 2**30 marks an empty slot): it emits -1 and writes nothing. The K/V cache
// (L, 2, B, C, E) and the carry (each slot's next input token) stay on the
// card between launches, so the scheduler can evict and admit at every
// segment boundary.
//
// What bounds it: HBM bytes and the phases' latency chains, as decode_wide.
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
//     count (at most one split for every 64 keys), so no split is empty;
//   * the sample of slot s at global step i draws the Philox noise of
//     (seed, s, i), decode_segment's key: a row's stream does not depend on
//     how the loop is cut into segments nor on when other rows were admitted.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: decode_wide_segment(...), returns the launch's cudaError_t.

#include "decode_wide_common.cuh"

namespace {

using namespace decode_common;
using namespace decode_wide_common;

template <typename W, typename A>
__global__ void __launch_bounds__(kThreads, 1)
    decode_wide_segment_kernel(const WideArgs<W, A> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kStreamed = !std::is_same<W, float>::value;
  const Smem sm(smem, union_bytes(a.slots, a.embed, a.head_dim, a.vocab_pad, sizeof(A)));
  RowList& R = *sm.rows;
  const int slots = a.slots, P = a.prompt_width, tid = threadIdx.x;

  WeightStream<W, A> ws;
  if constexpr (kStreamed)
    ws.init(a.big_w, a.fp_w, a.logits_w, a.embed, a.layers, a.vocab_pad, sm.bars, sm.stages,
            sm.geom);
  // The input of each slot's first step in this segment: its own prompt
  // while the position is inside it (a slot admitted at this boundary must
  // not read the previous occupant's carry; a parked position clamps to the
  // prompt's first token), else the carried sample. Every block holds them.
  if (tid < slots) {
    const int plen = min(max(a.plens[tid], 1), P);
    const long long pos0 = (long long)a.step0 - a.starts[tid];
    R.tok[tid] = pos0 < plen ? a.prompts[tid * P + (pos0 < 0 ? 0 : (int)pos0)] : a.carry[tid];
  }
  // -1 for the steps a slot is parked.
  if (blockIdx.x == 0)
    for (int t = tid; t < slots * a.num_steps; t += kThreads) {
      const int s = t / a.num_steps, j = t - s * a.num_steps;
      if ((long long)a.step0 + j < a.starts[s]) a.tokens[t] = -1;
    }
  GridBarrier gb{a.barrier, 0u};
  StepClock clk(a.clock);

  for (int j = 0; j < a.num_steps; ++j) {
    const int i = a.step0 + j;
    __syncthreads();  // the last step's readers of the row list are done
    // The step's active rows in slot order, the same list in every block.
    if (tid == 0) {
      int B = 0;
      for (int s = 0; s < slots; ++s) {
        const long long pos = (long long)i - a.starts[s];
        if (pos >= 0) {
          R.slot[B] = s;
          R.pos[B] = (int)pos;
          R.key_pos[B] = min((int)pos, a.live - 1);
          R.write[B] = pos < a.live;
          ++B;
        }
      }
      R.count = B;
      plan_splits(R, a.heads);
    }
    __syncthreads();
    if (R.count == 0) continue;  // every block skips the same steps
    const StepOut so{j, (unsigned)i, false, true};
    wide_step<W, A, false>(a, sm, ws, gb, clk, so);
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < slots) a.carry[tid] = R.tok[tid];
  if constexpr (kStreamed) ws.drain();
}

template <typename W, typename A>
int run(int device, int grid, const void* const* p, int scratch_size, const int* dims,
        unsigned seed, float softmax_scale, float eps, void* stream) {
  WideArgs<W, A> a = {};
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
  a.slots = dims[0];
  a.prompt_width = dims[1];
  a.layers = dims[2];
  a.heads = dims[3];
  a.head_dim = dims[4];
  a.embed = dims[5];
  a.cache_len = dims[6];
  a.window = dims[7];
  a.vocab_pad = dims[8];
  a.step0 = dims[9];
  a.num_steps = a.out_len = dims[10];
  a.live = dims[11];
  a.use_rel = dims[12];
  a.seed = seed;
  a.softmax_scale = softmax_scale;
  a.eps = eps;
  if (!widths_ok(a.slots, a.embed, a.head_dim) || a.live < 1 || a.live > a.cache_len ||
      a.num_steps < 1 || a.kv == nullptr ||
      (size_t)scratch_size < scratch_floats(a.slots, a.embed, a.heads, a.head_dim, a.vocab_pad))
    return (int)cudaErrorInvalidValue;
  a.bind_scratch(scratch);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(a.slots, a.embed, a.head_dim, a.vocab_pad, sizeof(W),
                                 sizeof(A));
  return launch_cooperative(decode_wide_segment_kernel<W, A>, a, smem, device, grid,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

// weight_kind: 0 float32, 1 bfloat16, 2 int8 (bf16 tables, activations and
// K/V). Pointers in the order of
// ops/decode_kernel_wide_segmented.py::decode_segment_wide; wscale and
// fpscale are null for float weights, clock when it is off. The scratch
// (scratch_floats()) must be zeroed.
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
