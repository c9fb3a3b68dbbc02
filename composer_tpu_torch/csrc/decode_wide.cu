// decode_wide: the whole autoregressive generation of the Music Transformer in
// one kernel launch, for models whose weights outgrow the card's fast memory,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel composer_tpu/ops/decode_kernel_wide.py (_wide_kernel).
// Same contract as the plain PyTorch version
// composer_tpu_torch/ops/decode_kernel_wide.py::decode_wide_reference.
//
// What bounds it: at embed 1024 the packed weights are about 200 MB of bf16,
// four times the 50 MB L2, so every step streams them from HBM, plus each
// layer's K/V prefix; one block per sequence (decode_generate) would read
// them once per block per step. Here one persistent block per SM, launched
// cooperatively, runs the step body of decode_wide_common.cuh (wide_step):
// in each matmul phase a block owns a fixed slice of the output columns,
// streamed into shared memory ahead of the phase's grid barrier, and
// applies every weight it loads to all B rows on tensor cores, so each
// weight byte is read from HBM once per step, by all SMs at once. What the
// header's description says of the phases, the barriers and the numerics
// holds here; this file is the set-up, the step loop and the entry point.
//
// Every row runs at the same position: row b is slot b, teacher-forced while
// inside its prompt, fed back its own sample after; its sample at step pos
// draws the Philox noise of (seed, pos, b), decode_generate's.
//
// int8 K/V (kv_quant): a row is written to a float window of kTail rows and
// quantized (per row, k and v apart) in the next phase; it is read
// quantized from the step its window completes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry point: decode_wide(...), returns the launch's cudaError_t.

#include "decode_wide_common.cuh"

namespace {

using namespace decode_common;
using namespace decode_wide_common;

template <typename W, typename A, bool KVQ>
__global__ void __launch_bounds__(kThreads, 1) decode_wide_kernel(const WideArgs<W, A> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kStreamed = !std::is_same<W, float>::value;
  const Smem sm(smem, union_bytes(a.slots, a.embed, a.head_dim, a.vocab_pad, sizeof(A)));
  RowList& R = *sm.rows;
  const int B = a.slots, tid = threadIdx.x;

  WeightStream<W, A> ws;
  if constexpr (kStreamed)
    ws.init(a.big_w, a.fp_w, a.logits_w, a.embed, a.layers, a.vocab_pad, sm.bars, sm.stages,
            sm.geom);
  if (tid == 0) R.count = B;
  if (tid < B) R.tok[tid] = a.prompts[tid * a.prompt_width];
  GridBarrier gb{a.barrier, 0u};
  StepClock clk(a.clock);

  for (int pos = 0; pos < a.num_steps; ++pos) {
    __syncthreads();  // the last step's readers of the row list are done
    if (tid == 0) {
      for (int b = 0; b < B; ++b) {
        R.slot[b] = b;
        R.pos[b] = R.key_pos[b] = pos;
        R.write[b] = 1;
      }
      plan_splits(R, a.heads);
    }
    __syncthreads();
    const StepOut so{pos, (unsigned)pos,
                     pos == a.num_steps - 1 && a.logits_out != nullptr, false};
    wide_step<W, A, KVQ>(a, sm, ws, gb, clk, so);
  }
  if constexpr (kStreamed) ws.drain();
}

template <typename W, typename A, bool KVQ>
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
  a.kq = static_cast<int8_t*>(const_cast<void*>(p[15]));
  a.ks = static_cast<float*>(const_cast<void*>(p[16]));
  a.tail = static_cast<A*>(const_cast<void*>(p[17]));
  a.prompts = static_cast<const int*>(p[18]);
  a.plens = static_cast<const int*>(p[19]);
  a.temps = static_cast<const float*>(p[20]);
  a.topk = static_cast<const float*>(p[21]);
  a.topp = static_cast<const float*>(p[22]);
  a.tokens = static_cast<int*>(const_cast<void*>(p[23]));
  a.logits_out = static_cast<float*>(const_cast<void*>(p[24]));
  float* scratch = static_cast<float*>(const_cast<void*>(p[25]));
  a.clock = static_cast<unsigned long long*>(const_cast<void*>(p[26]));
  a.slots = dims[0];
  a.prompt_width = dims[1];
  a.layers = dims[2];
  a.heads = dims[3];
  a.head_dim = dims[4];
  a.embed = dims[5];
  a.cache_len = dims[6];
  a.window = dims[7];
  a.vocab_pad = dims[8];
  a.num_steps = dims[9];
  a.out_len = dims[10];
  a.use_rel = dims[11];
  a.seed = seed;
  a.softmax_scale = softmax_scale;
  a.eps = eps;
  if (!widths_ok(a.slots, a.embed, a.head_dim) ||
      (size_t)scratch_size < scratch_floats(a.slots, a.embed, a.heads, a.head_dim, a.vocab_pad))
    return (int)cudaErrorInvalidValue;
  if (KVQ ? (a.kq == nullptr || a.ks == nullptr || a.tail == nullptr) : a.kv == nullptr)
    return (int)cudaErrorInvalidValue;
  a.bind_scratch(scratch);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(a.slots, a.embed, a.head_dim, a.vocab_pad, sizeof(W),
                                 sizeof(A));
  return launch_cooperative(decode_wide_kernel<W, A, KVQ>, a, smem, device, grid,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

// weight_kind: 0 float32, 1 bfloat16, 2 int8 (bf16 tables and activations);
// kv_quant: int8 K/V with a float window. Pointers in the order of
// ops/decode_kernel_wide.py::decode_wide; unused ones are null. The scratch
// (scratch_floats()) must be zeroed.
extern "C" int decode_wide(
    int weight_kind, int kv_quant, int device, int grid, const void* big_w, const void* fp_w,
    const void* wscale, const void* fpscale, const void* wte, const void* logits_w,
    const void* wpe, const void* ln1, const void* qkv_b, const void* proj_b, const void* fc_b,
    const void* fp_b, const void* logits_b, const void* rel, void* kv, void* kq, void* ks,
    void* tail, const void* prompts, const void* plens, const void* temps, const void* topk,
    const void* topp, void* tokens, void* logits_out, void* scratch, void* clock,
    int scratch_size,
    int batch, int prompt_width, int layers, int heads, int head_dim, int embed, int cache_len,
    int window, int vocab_pad, int num_steps, int out_len, int use_rel, unsigned seed,
    float softmax_scale, float eps, void* stream) {
  const void* p[] = {big_w, fp_w, wscale, fpscale, wte, logits_w, wpe, ln1, qkv_b,
                     proj_b, fc_b, fp_b, logits_b, rel, kv, kq, ks, tail, prompts,
                     plens, temps, topk, topp, tokens, logits_out, scratch, clock};
  const int dims[] = {batch, prompt_width, layers, heads, head_dim, embed, cache_len,
                      window, vocab_pad, num_steps, out_len, use_rel};
  using bf16 = __nv_bfloat16;
  switch (weight_kind * 2 + (kv_quant ? 1 : 0)) {
    case 0: return run<float, float, false>(device, grid, p, scratch_size, dims, seed,
                                            softmax_scale, eps, stream);
    case 1: return run<float, float, true>(device, grid, p, scratch_size, dims, seed,
                                           softmax_scale, eps, stream);
    case 2: return run<bf16, bf16, false>(device, grid, p, scratch_size, dims, seed,
                                          softmax_scale, eps, stream);
    case 3: return run<bf16, bf16, true>(device, grid, p, scratch_size, dims, seed,
                                         softmax_scale, eps, stream);
    case 4: return run<int8_t, bf16, false>(device, grid, p, scratch_size, dims, seed,
                                            softmax_scale, eps, stream);
    case 5: return run<int8_t, bf16, true>(device, grid, p, scratch_size, dims, seed,
                                           softmax_scale, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
