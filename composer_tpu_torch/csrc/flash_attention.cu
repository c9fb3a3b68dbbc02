// flash_attention: causal attention with the Music-Transformer relative bias
// and in-kernel dropout, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels composer_tpu/ops/pallas_attention.py
// _flash_kernel (forward) and _flash_bwd_kernel (merged backward). Same
// contract as the plain PyTorch versions in
// composer_tpu_torch/ops/flash_attention.py (flash_attention_reference,
// flash_attention_backward_reference).
//
// Layout: q, k, v, out, dout, dk, dv are [BH, S, D] in T (float or bf16);
// the relative table E is [H, W, D] in T, E[h, W-1-d] holding distance d;
// lse and delta = rowsum(dout * out) are [BH, S] float32; dq [BH, S, D] and
// dE [H, W, D] are float32 sums that the caller zeroes and casts back.
//
//   score(i, j) = (q_i . k_j + q_i . E[h, W-1-(i-j)]) * scale,  j <= i
//   p(i, j)     = exp(score - lse_i),  lse_i = log sum_j exp(score(i, j))
//   out_i       = sum_j p(i, j) * M(i, j) * v_j
//
// The bias is added before the scale, as in _tile_scores. Keys after the
// query get -1e30 (probability exactly 0). M is the dropout multiplier:
// keep_scale = 1/(1-rate) where the 32-bit Philox4x32-10 word for (q
// position, k position) is >= threshold = rate * 2^32, else 0. The word is
// word (k & 3) of Philox with counter (k >> 2, q, bh, 0) and key (seed, 0),
// one per element, so the backward regenerates the forward's mask whatever
// its tiling; the row normaliser l comes from the undropped p.
//
// Two pairs of kernels, one per route (ops/flash_attention.py::kernel_variant),
// each built at head_dim 16, 32, 64 and 128 (the wrapper zero-pads any
// other head_dim up to 128 to the next of these, as the JAX wrapper pads to
// 128 lanes, with the scale of the true depth):
//
// * bf16: the tensor-core kernels of
//   flash_attention_mma.cuh (flash_forward_mma_kernel, replacing
//   _flash_kernel; flash_backward_mma_kernel, replacing _flash_bwd_kernel).
//   Every product is mma.sync.m16n8k16 (bf16 in, float32 sums): QK^T, PV,
//   the relative band, and the backward's. What bounds them on this card is
//   not the tensor cores (chip_smoke.py's flash_bound is several times
//   below their time; PERF.md) but the work around each score and the
//   shared-memory and atomic traffic: at head_dim 16 a score takes 2 x 16 operations of QK^T
//   and PV against one exp2, a mask test and, with dropout, a quarter of a
//   10-round Philox call; the band adds a product and a skewed read. The
//   design keeps that work small and off the critical path:
//   - 4 warps of 16 rows a block; Q fragments in registers; tiles staged
//     with cp.async (the forward's K, V and E double-buffered) at a padded
//     pitch, so ldmatrix is free of bank conflicts; P goes from the S accumulators to the PV
//     operands in registers;
//   - exp2 with the scale and log2(e) folded into one multiply;
//   - dropout: one Philox call (4 words) a lane per 8-key tile, its words
//     handed to the lanes that need them through a per-warp shared buffer (selects and
//     shuffles cost more than the Philox rounds);
//   - the relative band as a product: a warp's 16 rows reach 80 band rows,
//     so q.E is one 16 x 80 product, staged in the warp's shared memory and
//     read back skewed (the Music Transformer's skew), with no block barrier
//     in the forward;
//   - shared memory sized by the bias, so that more blocks fit an SM without
//     it (at D=128 with the bias, about 162 KB: one block an SM).
//   The backward recomputes P from lse (FlashAttention-2 order, one 64-key
//   tile a block, 16 keys a warp), keeps dK and dV in registers, stages dS^T
//   in shared memory as bf16 and forms dq = c (dS K + Bm E_band) from it (Bm
//   the skewed dS), sent with 4-float atomics. dE_band = c Bm^T Q: each warp
//   keeps the 16 band rows it owns in registers; a q-tile's low rows are
//   the next q-tile's high rows of the same warp, so each dE row leaves
//   once, as 4-float atomics, when no later q-tile reaches it. At D=128 the
//   accumulators of dK, dV, dE and dq (4 x 64 floats a thread) exceed the
//   255 registers, so two warps share a key group, each owning half of the
//   columns (bwd_split; 8 warps a block).
// * float32: the split-TF32 tensor-core kernels of flash_attention_tf32.cuh
//   (flash_forward_tf32_kernel, replacing _flash_kernel;
//   flash_backward_tf32_kernel, replacing _flash_bwd_kernel; route
//   "tf32x3"). Every product, QK^T, the band q.E, PV and the backward's
//   recomputed S and band, dO V^T, P^T dO, dS K, dS E, dS^T Q and dE, is
//   mma.sync.m16n8k8 in TF32 three times: each operand x, P and dS
//   included, splits into big = tf32(x) and small = tf32(x - big) (rounded
//   as cvt.rna.tf32.f32 rounds, by two integer operations), and big small +
//   small big + big big is accumulated in float32 in that order, which keeps
//   float32's accuracy (one TF32 product misses the float32 tolerance by
//   4-12x). What bounds them: three tensor-core products and the splits for
//   each float32 one (the bound counts the products at a third of the 495
//   TFLOP/s TF32 rate), and the same work around each score as the bf16
//   kernels. The design is the bf16 one with float32 tiles at pitch D+4
//   (rows g apart, and rows 2t apart, land on distinct banks) read by 32-bit
//   ld.shared: 4 warps of 16 rows, online softmax in exp2, one Philox call a
//   lane per 8-key tile handed on through a per-warp buffer, the band as one
//   16 x 80 product a warp read back skewed, FlashAttention-2's backward with
//   dK and dV in registers, dq by 4-float atomics, each dE row sent once.
//   What float32 changes: an operand from a C fragment (P, dS^T) is used as
//   an A fragment as it lies by permuting the depth of each 8-wide step (2t
//   as t, 2t+1 as t+4), its B operand reading rows 2t and 2t+1; Q is staged
//   and split per k-step instead of held in registers; the forward waits for
//   K (with the band) and V apart, single-buffered, so the next K lands
//   during softmax and PV. The backward's accumulators take two warps a key
//   group from D=64 (8 warps a block); the group's warp 0 forms S^T and its
//   warp 1 dP^T, exchanged through shared memory, except at D=128 with the
//   bias, where the 32 KB do not fit and both form both. Its staged dS
//   shares its bytes with the q.E staging (one more barrier), and at D=128
//   its q-tile is single-buffered: K, V, Q, dO and the band take 198 KB.
//
// Blocks of different (b, k-tile) share dq and dE rows, which the TPU
// accumulated in place only because its grid ran in order; the atomics make
// the summation order vary between runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C entry points: flash_attention_forward(...), flash_attention_backward(...);
// each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;          // rows per tile
constexpr int kBand = 2 * kBlock;   // relative-table rows one tile can need
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* e;       // [H, W, D] or null
  const void* dout;    // backward only
  void* out;           // forward only
  float* lse;          // [BH, S]
  const float* delta;  // [BH, S], backward only
  const int* seed;     // one int32 on the device, read when dropout is on
  float* dq;           // [BH, S, D] float32 sums, backward only
  void* dk;
  void* dv;
  float* de;           // [H, W, D] float32 sums, backward with the bias only
  int bh, heads, seq, window, use_rel, dropout;
  float scale, keep_scale;
  unsigned threshold;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, ctr.x), lo0 = 0xD2511F53u * ctr.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, ctr.z), lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// The bf16 tensor-core kernels, then the float32 ones (split TF32), which
// share the bf16 file's staging, atomics and dropout constants.
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"

template <typename K>
int launch(K kernel, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > (size_t)kMaxSharedBytes || a.seq % kBlock != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.seq / kBlock, a.bh), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instances built, one per (route, head_dim) of
// ops/flash_attention.py::VARIANTS (head_dim 16, 32, 64 and 128 on each
// route; the wrapper pads any other head_dim up to the next of them); any
// other head_dim is refused.
template <int D>
int forward_at(int mma, const Args& a, cudaStream_t stream) {
  if (mma) {
    return launch(flash_forward_mma_kernel<D>, kMmaThreads, forward_mma_smem<D>(a.use_rel), a,
                  stream);
  }
  return launch(flash_forward_tf32_kernel<D>, kF32Threads, forward_f32_smem<D>(a.use_rel), a,
                stream);
}

template <int D>
int backward_at(int mma, const Args& a, cudaStream_t stream) {
  if (mma) {
    return launch(flash_backward_mma_kernel<D>, bwd_threads<D>(), backward_mma_smem<D>(a.use_rel),
                  a, stream);
  }
  return launch(flash_backward_tf32_kernel<D>, bwd_f32_threads<D>(),
                backward_f32_smem<D>(a.use_rel), a, stream);
}

int forward(int mma, int depth, const Args& a, cudaStream_t stream) {
  switch (depth) {
    case 16: return forward_at<16>(mma, a, stream);
    case 32: return forward_at<32>(mma, a, stream);
    case 64: return forward_at<64>(mma, a, stream);
    case 128: return forward_at<128>(mma, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int backward(int mma, int depth, const Args& a, cudaStream_t stream) {
  switch (depth) {
    case 16: return backward_at<16>(mma, a, stream);
    case 32: return backward_at<32>(mma, a, stream);
    case 64: return backward_at<64>(mma, a, stream);
    case 128: return backward_at<128>(mma, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* e, const void* lse,
               const void* seed, int bh, int heads, int seq, int window, int use_rel,
               float scale, unsigned threshold, float keep_scale, int dropout) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.e = e;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.seed = static_cast<const int*>(seed);
  a.bh = bh;
  a.heads = heads;
  a.seq = seq;
  a.window = window;
  a.use_rel = use_rel;
  a.dropout = dropout;
  a.scale = scale;
  a.keep_scale = keep_scale;
  a.threshold = threshold;
  return a;
}

}  // namespace

extern "C" int flash_attention_forward(
    int mma, int device, const void* q, const void* k, const void* v, const void* e,
    void* out, void* lse, const void* seed, int bh, int heads, int seq, int depth,
    int window, int use_rel, float scale, unsigned threshold, float keep_scale, int dropout,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, e, lse, seed, bh, heads, seq, window, use_rel, scale,
                     threshold, keep_scale, dropout);
  a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return forward(mma, depth, a, s);
}

extern "C" int flash_attention_backward(
    int mma, int device, const void* q, const void* k, const void* v, const void* e,
    const void* dout, const void* lse, const void* delta, const void* seed, void* dq,
    void* dk, void* dv, void* de, int bh, int heads, int seq, int depth, int window,
    int use_rel, float scale, unsigned threshold, float keep_scale, int dropout,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(q, k, v, e, lse, seed, bh, heads, seq, window, use_rel, scale,
                     threshold, keep_scale, dropout);
  a.dout = dout;
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = dk;
  a.dv = dv;
  a.de = static_cast<float*>(de);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward(mma, depth, a, s);
}
