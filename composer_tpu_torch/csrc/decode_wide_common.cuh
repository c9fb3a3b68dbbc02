// The step body shared by the two streamed-weight decode kernels,
// decode_wide.cu (one whole generation) and decode_wide_segment.cu (segments
// of a continuous batch), and the pieces it is made of. Each kernel keeps only
// its set-up, its step loop (which rows run at which position) and its C
// entry point; wide_step runs one decode step of the active rows.
//
// Both kernels run one persistent kThreads-thread block per SM, launched
// cooperatively (so every block is resident), with grid barriers between the
// phases of a step:
//
//   per layer  P1  ln_1 + qkv columns; k, v to the cache (or the int8 window)
//              P2  attention: (row, head, key split) items, one per block;
//                  the last split of a (row, head) to finish merges the
//                  partials into the head's output
//              P3  attention-proj columns + residual
//              P4  ln_2 + mlp-fc columns + GELU
//              P5  mlp-proj columns + residual
//   per step   P6  ln_f + tied-head columns
//              P7  sampling
//
// What bounds the step is not bytes (200 MB of bf16 weights a step at the
// flagship's embed 1024 take 60 us at 3.35 TB/s) but each phase's chain of
// latencies. The design cuts that chain:
//
// * Weight stream. In every matmul phase a block owns a fixed slice of the
//   output columns: tiles of up to kMaxTileUnits units of 8 columns
//   (tile_geom: the slice depends only on gridDim.x and the widths; a tile
//   that would exceed a stage splits K). The weights are packed output-major,
//   so a tile is a contiguous run of rows: thread 0 streams it into one of
//   two kStageBytes stages of shared memory with cp.async.bulk, completed on
//   the stage's mbarrier (WeightStream). A stage is refilled with the block's
//   next tile as soon as the tile in it is consumed, so each tile is loaded
//   while the block works through the phase before it and waits at its
//   barrier: the HBM round trip leaves the phase's chain. The tiles carry an
//   L2 evict-first policy (kEvictFirst), so the stream does not push out of
//   the L2 what the step reuses. The float32-weight instantiation, which
//   exists to hold ids to the plain version, keeps direct loads
//   (gemv_phase) in the same phases and barriers.
// * Tensor-core products. bf16 and int8 weights run mma.sync.m16n8k16 (bf16
//   in, float32 sums): the rows (B <= 8, the other 8 of m zero) are operand
//   A, 8 output columns of a tile operand B, so a tile's granularity is 8
//   columns and proj's and fp's 1024 columns spread over 128 blocks. Each
//   lane loads 8 consecutive k of its column and row (16 bytes of bf16, 8 of
//   int8, which converts to bf16 exactly) and feeds two products, the same
//   permutation of k in both operands. Warps split a tile's K; their sums
//   are combined in a fixed order. The operand rows live in shared memory as
//   bf16 (they are rounded to the activation type anyway), half the floats'.
// * Activations. After a barrier a phase's input rows (h, x2, the attention
//   output or the MLP hidden, B x E or B x 4E) arrive with cp.async, all in
//   flight at once; the epilogue's read-only scales and biases and its
//   residual (x1 or x2, written two barriers earlier) are loaded into
//   registers before that wait (Pre).
// * Attention. An item is a (row, head, key split) on a block, whose 4 warp
//   groups take quarters of the split's keys; the splits (at most one for
//   every 64 keys, at most kMaxSplits) cover the grid, so at B=8 x 16 heads
//   on 132 SMs a (row, head) has a block to itself and at B=1 it has 8.
//   Each thread group of D / VA lanes walks its keys once with an online
//   softmax (K, V and the relative band row loaded together), the block's
//   thread groups merge in order in shared memory, and where a (row, head)
//   has several splits the one that finishes last (an integer counter per
//   (row, head); the merge order is fixed, so the result does not depend on
//   which) merges their partials into the head's output, which P3 then
//   reads as one B x E row block.
// * Barriers. GridBarrier is a split arrive / wait on a counter in L2 (an
//   acq_rel fence and add, an acquire spin); the block's next weight tile is
//   issued before the arrive, as soon as its stage is free, earlier than the
//   split alone would allow. Sampling needs no barrier: every block samples
//   every row itself (sample_rows: a team of warps a row, sample_row's
//   token, with top-k / top-p read off a sorted row), so the sampled tokens
//   never cross the grid. A step takes 5 L + 1 grid barriers (41 at 8
//   layers; 42 before). The other cut considered, a
//   thread-block cluster per head joining P1 and P2, is not taken: a head's
//   qkv columns would have to land on one cluster at every grid size.
// * Registers. The step body and its parts are inlined: compiled as calls,
//   the weight stream's and the barrier's state lived in local memory,
//   which with about 200 KB of shared memory has little L1 left, so each of
//   their many accesses a phase could cost an L2 round trip. The tile
//   geometry sits in shared memory for the same reason (a runtime index).
//
// Numerics: matmul inputs are rounded to the activation type A (bf16 for
// bf16 and int8 weights), products accumulate in float32, and an int8
// weight's per-column scale multiplies the sum. q is rounded to A; scores,
// softmax and the AV sum stay float32. Sampling is decode_common.cuh's (the
// Philox Gumbel noise equals decode_generate's). Every partial sum is
// combined in a fixed order; no float atomics.

#pragma once

#include <type_traits>

#include "decode_common.cuh"

namespace decode_wide_common {

using namespace decode_common;

constexpr int kMaxBatch = 8;    // MAX_BATCH in ops/decode_kernel_wide.py
constexpr int kMaxSplits = 16;  // MAX_SPLITS
constexpr int kTail = 128;      // TAIL: rows of the float window of int8 K/V
constexpr int kGroupThreads = 128;  // a warp group
constexpr int kGroupsPerBlock = kThreads / kGroupThreads;
constexpr int kStageBytes = 65536;  // STAGE_BYTES: one weight stage
constexpr int kMaxTileUnits = kWarps;  // units of 8 columns a tile
constexpr int kMinSplitKeys = 64;
// Shared memory ahead of the union (HEADER_BYTES): the two stages'
// mbarriers, the row list and the matmul phases' tile geometry (512 bytes),
// 64 floats of reductions and kGredFloats of matmul partial sums.
constexpr int kInfoBytes = 512;
constexpr int kGeomOffset = 256;
constexpr int kGredFloats = 1024;
constexpr int kHeaderBytes = kInfoBytes + 4 * (64 + kGredFloats);
// The clock's slots (PHASES in ops/decode_kernel_wide.py): the phase kinds
// P1-P7 (block 0's own work not counted below), the matmul phases' wait for
// their input rows with the LayerNorm, their wait for weight tiles, the
// attention's key pass and its merge (block 0's first warp group), the wait
// at grid barriers, and the count of grid barriers.
constexpr int kClockInputs = 7, kClockWeights = 8, kClockKeys = 9, kClockMerge = 10;
constexpr int kClockWait = 11, kClockBarriers = 12;

// ---------------------------------------------------------------------------
// Loads.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N consecutive elements as floats: ld.global.cg (L2) for data written in
// this launch, plain loads for read-only tables.
template <typename T, int N> struct Load;
template <> struct Load<float, 4> {
  static __device__ __forceinline__ void cg(const float* p, float* out) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void ro(const float* p, float* out) {
    Vec<float>::load(p, out);
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void cg(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pairs[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void ro(const __nv_bfloat16* p, float* out) {
    Vec<__nv_bfloat16>::load(p, out);
  }
};
template <> struct Load<int8_t, 4> {
  static __device__ __forceinline__ void cg(const int8_t* p, float* out) {
    const char4 v = __ldcg(reinterpret_cast<const char4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Load<int8_t, 8> {
  static __device__ __forceinline__ void cg(const int8_t* p, float* out) {
    const int2 v = __ldcg(reinterpret_cast<const int2*>(p));
    const char4 lo = *reinterpret_cast<const char4*>(&v.x);
    const char4 hi = *reinterpret_cast<const char4*>(&v.y);
    out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
    out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
  }
};

// dst[0, bytes) = src[0, bytes), bytes a multiple of 16, from data written
// in this launch (cp.async.cg reads L2): every 16-byte copy of the block in
// flight at once. Completes at cp_async_wait_all.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(static_cast<char*>(dst) + i)),
                 "l"(static_cast<const char*>(src) + i)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The grid barrier: a split arrive / wait on a counter in L2 (zeroed by the
// wrapper). arrive() publishes the block's writes (block barrier, then one
// thread's acq_rel fence and relaxed add: cutlass/barrier.h's form, cheaper
// than __threadfence's sequentially consistent fence); wait() spins with
// acquire loads until every block has arrived, then releases the block.
// Work between the two must not depend on other blocks.

__device__ __forceinline__ void acq_rel_fence() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

struct GridBarrier {
  unsigned* counter;
  unsigned target;  // thread 0's count of arrivals to wait for
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    if (threadIdx.x == 0)
      asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                   : "memory");
  }
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      target += gridDim.x;
      while (static_cast<int>(ld_acquire(counter) - target) < 0) {
      }
    }
    __syncthreads();
  }
};

// The optional clock (phase_ns in the wrappers): block 0's thread 0 adds the
// time since its last mark to a slot. A phase's slot gets block 0's own work
// (marked at the arrive that ends it) less what the sub-slots take,
// kClockWait the time it then waits at the barrier, kClockBarriers one per
// grid barrier.
struct StepClock {
  unsigned long long* slots;
  bool on;
  unsigned long long last;
  __device__ explicit StepClock(unsigned long long* clock)
      : slots(clock), on(clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0),
        last(on ? global_ns() : 0) {}
  __device__ __forceinline__ void mark(int slot) {
    if (on) {
      const unsigned long long now = global_ns();
      slots[slot] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void count() {
    if (on) slots[kClockBarriers] += 1;
  }
};

// ---------------------------------------------------------------------------
// The weight stream.

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A matmul phase's tiles: units of 8 output columns over K. A tile holds
// upt units of the whole K (kts = 1) or, where one unit of K outgrows a
// stage, one unit of kc of K (kts chunks, kc a multiple of 32). Column group
// g (upt units) belongs to block g % grid, which takes its groups in order.
// tile_geom in ops/decode_kernel_wide.py mirrors it.
struct TileGeom {
  int units, upt, kc, kts, groups, K, wb;
};
__host__ __device__ inline TileGeom tile_geom(int N, int K, int wb, int grid) {
  TileGeom t;
  t.K = K;
  t.wb = wb;
  t.units = N / 8;
  const int unit_bytes = 8 * K * wb;
  if (unit_bytes <= kStageBytes) {
    int upt = (t.units + grid - 1) / grid;
    if (upt > kStageBytes / unit_bytes) upt = kStageBytes / unit_bytes;
    if (upt > kMaxTileUnits) upt = kMaxTileUnits;
    t.upt = upt;
    t.kc = K;
    t.kts = 1;
  } else {
    t.upt = 1;
    t.kc = kStageBytes / (8 * wb) / 32 * 32;
    t.kts = (K + t.kc - 1) / t.kc;
  }
  t.groups = (t.units + t.upt - 1) / t.upt;
  return t;
}

// L2 cache policy of the weight tiles: evict first (CacheHintSm90::
// EVICT_FIRST in CUTLASS). 200 MB of weights a step stream through the 50 MB
// L2; without the hint they evict what the step reuses (activations, K/V,
// the relative table, the kernel's own instructions).
constexpr unsigned long long kEvictFirst = 0x12F0000000000000ull;

// The kinds of matmul phase, in a step's order: per layer qkv, proj, fc,
// fp; then the tied logits. (N, K) = (3E, E), (E, E), (4E, E), (E, 4E),
// (Vpad, E).
enum MatmulKind { kQkv = 0, kProj = 1, kFc = 2, kFp = 3, kLogits = 4 };

// Each block's tiles of every matmul phase, in the order the step consumes
// them, streamed two ahead into two stages. All threads keep the same
// counters; thread 0 issues the copies. Only for bf16 and int8 weights.
template <typename W, typename A>
struct WeightStream {
  uint64_t* bar;  // [2], one per stage
  char* stage;    // [2][kStageBytes]
  const W* big_w;
  const W* fp_w;
  const A* logits_w;
  int E, L;
  const TileGeom* geom;  // [5] in shared memory, by MatmulKind
  bool any;                       // the block owns at least one tile
  int layer, kind, group, chunk;  // the next tile to issue
  int issued, consumed;

  __device__ __forceinline__ void init(const W* big, const W* fp, const A* lw, int embed,
                                       int layers, int vpad, uint64_t* bars, char* stages,
                                       TileGeom* shared_geom) {
    bar = bars;
    stage = stages;
    geom = shared_geom;
    big_w = big;
    fp_w = fp;
    logits_w = lw;
    E = embed;
    L = layers;
    if (threadIdx.x == 0) {
      const int g = gridDim.x;
      shared_geom[kQkv] = tile_geom(3 * E, E, sizeof(W), g);
      shared_geom[kProj] = tile_geom(E, E, sizeof(W), g);
      shared_geom[kFc] = tile_geom(4 * E, E, sizeof(W), g);
      shared_geom[kFp] = tile_geom(E, 4 * E, sizeof(W), g);
      shared_geom[kLogits] = tile_geom(vpad, E, sizeof(A), g);
      mbar_init(bar);
      mbar_init(bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    any = false;
    for (int k = 0; k < 5; ++k) any = any || (int)blockIdx.x < geom[k].groups;
    issued = consumed = 0;
    layer = 0;
    kind = kQkv;
    group = blockIdx.x;
    chunk = 0;
    if (!any) return;
    seek();
    for (int s = 0; s < 2; ++s) post();
  }

  // Moves the cursor to the block's next tile at or after it.
  __device__ __forceinline__ void seek() {
    while (group >= geom[kind].groups) {
      group = blockIdx.x;
      if (kind == kFp && layer + 1 < L) {
        kind = kQkv;
        ++layer;
      } else if (kind == kFp) {
        kind = kLogits;
      } else if (kind == kLogits) {
        kind = kQkv;
        layer = 0;
      } else {
        ++kind;
      }
    }
  }

  __device__ __forceinline__ const char* weights(int k, int l) const {
    const size_t EE = (size_t)E * E;
    switch (k) {
      case kQkv: return reinterpret_cast<const char*>(big_w + (size_t)l * 8 * EE);
      case kProj: return reinterpret_cast<const char*>(big_w + ((size_t)l * 8 + 3) * EE);
      case kFc: return reinterpret_cast<const char*>(big_w + ((size_t)l * 8 + 4) * EE);
      case kFp: return reinterpret_cast<const char*>(fp_w + (size_t)l * 4 * EE);
      default: return reinterpret_cast<const char*>(logits_w);
    }
  }

  // Issues the tile at the cursor into stage issued % 2 and advances.
  __device__ __forceinline__ void post() {
    const TileGeom& g = geom[kind];
    if (threadIdx.x == 0) {
      uint64_t* b = bar + (issued & 1);
      char* dst = stage + (size_t)(issued & 1) * kStageBytes;
      const int units = min(g.upt, g.units - group * g.upt);
      const int col0 = group * g.upt * 8;
      const int k0 = chunk * g.kc, klen = min(g.kc, g.K - k0);
      const char* src = weights(kind, layer) + ((size_t)col0 * g.K + k0) * g.wb;
      const unsigned bytes = (unsigned)(units * 8 * klen * g.wb);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
                   "r"(bytes)
                   : "memory");
      // One copy for a whole-K tile (its rows are contiguous), one a row
      // for a K chunk.
      const int copies = g.kts == 1 ? 1 : units * 8;
      const unsigned each = bytes / copies;
      for (int r = 0; r < copies; ++r)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
            "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst + (size_t)r * each)),
            "l"(src + (size_t)r * g.K * g.wb), "r"(each), "r"(smem_u32(b)),
            "l"(kEvictFirst)
            : "memory");
    }
    ++issued;
    if (++chunk == g.kts) {
      chunk = 0;
      group += gridDim.x;
      seek();
    }
  }

  // The stage holding the next tile to consume, once it has landed.
  __device__ __forceinline__ const char* acquire() const {
    uint64_t* b = bar + (consumed & 1);
    while (!mbar_try_wait(b, (unsigned)((consumed >> 1) & 1))) {
    }
    return stage + (size_t)(consumed & 1) * kStageBytes;
  }

  // After the block has finished reading the acquired stage (a block
  // barrier): refill it with the block's next tile.
  __device__ __forceinline__ void release() {
    ++consumed;
    if (any) post();
  }

  // Waits for the tiles still in flight, so that none lands after the block
  // has exited.
  __device__ __forceinline__ void drain() {
    if (!any) return;
    while (consumed < issued) {
      acquire();
      ++consumed;
    }
  }
};

// ---------------------------------------------------------------------------
// Matmul phases.

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32.
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0, unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Two int8 (in the low 16 bits of w, lower k first) as a bf16 pair: exact.
__device__ __forceinline__ unsigned bf16x2_from_i8x2(unsigned w) {
  const float lo = (float)((int)(w << 24) >> 24), hi = (float)((int)(w << 16) >> 24);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A tile's 8 (or 4) consecutive k of one column as bf16 pairs.
template <typename W> struct TileK;
template <> struct TileK<__nv_bfloat16> {
  static __device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
};
template <> struct TileK<int8_t> {
  static __device__ __forceinline__ uint4 load8(const int8_t* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_uint4(bf16x2_from_i8x2(w.x), bf16x2_from_i8x2(w.x >> 16),
                      bf16x2_from_i8x2(w.y), bf16x2_from_i8x2(w.y >> 16));
  }
  static __device__ __forceinline__ uint2 load4(const int8_t* p) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    return make_uint2(bf16x2_from_i8x2(w), bf16x2_from_i8x2(w >> 16));
  }
};

// One warp's share of a tile's products for its unit: c[0..1] = row g's sums
// of columns 2t, 2t+1 (g = lane / 4, t = lane % 4) over the k-steps
// member, member + G, ... of [0, klen). A step is 32 k: lane (g, t) loads k
// [8t, 8t+8) of column g (operand B) and of row g (operand A) and runs two
// products, the first on k 8t..8t+3, the second on 8t+4..8t+7 (the same
// permutation of k on both sides), into two accumulators so that two
// chains of products are in flight; a last step of 16 k where klen % 32 =
// 16.
template <typename W>
__device__ __forceinline__ void mma_tile(float (&c)[4], const W* w, int klen,
                                         const __nv_bfloat16* x, int K, int B, int member,
                                         int G) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const W* wc = w + (size_t)g * klen;
  const __nv_bfloat16* xr = x + (size_t)g * K;
  const bool row = g < B;
  const int full = klen / 32, steps = full + (klen % 32 != 0);
  float c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int ks = member; ks < steps; ks += G) {
    if (ks < full) {
      const int k = ks * 32 + 8 * t;
      const uint4 b = TileK<W>::load8(wc + k);
      const uint4 a = row ? *reinterpret_cast<const uint4*>(xr + k) : make_uint4(0, 0, 0, 0);
      mma16816(c, a.x, a.y, b.x, b.y);
      mma16816(c2, a.z, a.w, b.z, b.w);
    } else {
      const int k = ks * 32 + 4 * t;
      const uint2 b = TileK<W>::load4(wc + k);
      const uint2 a = row ? *reinterpret_cast<const uint2*>(xr + k) : make_uint2(0, 0);
      mma16816(c, a.x, a.y, b.x, b.y);
    }
  }
  c[0] += c2[0];
  c[1] += c2[1];
}

// What an epilogue reads of its output (row, column): the int8 column
// scale (1 without), the bias and the residual (0 without), loaded before
// the phase's products.
struct Pre {
  float scale, bias, resid;
};

// One matmul phase on the streamed tiles: y[b, j] = sum_k x[b, k] w[j, k]
// for the block's column groups; epi(b, j, y, pre(b, j)) once for each.
// x (B x K, bf16, row stride K) must be in shared memory when prepare()
// returns; the first group's pre() loads are issued before prepare(). Every
// thread of the block calls it.
template <typename TW, typename WS, typename Prep, typename PreFn, typename Epi>
__device__ __forceinline__ void mma_phase(WS& ws, int kind, const __nv_bfloat16* x, int B,
                                          float* gred, StepClock& clk, int phase, Prep prepare,
                                          PreFn pre, Epi epi) {
  const TileGeom g = ws.geom[kind];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool prepared = false;
  for (int group = blockIdx.x; group < g.groups || !prepared; group += gridDim.x) {
    const bool owned = group < g.groups;
    const int U = owned ? min(g.upt, g.units - group * g.upt) : 0;
    const int col0 = group * g.upt * 8;
    const int outs = U * B * 8;
    Pre p[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < outs) p[i] = pre(e / 8 % B, col0 + e / (8 * B) * 8 + e % 8);
    }
    if (!prepared) {
      clk.mark(phase);
      prepare();
      clk.mark(kClockInputs);
      prepared = true;
    }
    if (!owned) break;
    const int G = kWarps / U, unit = warp / G, member = warp % G;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < g.kts; ++ch) {
      clk.mark(phase);
      const TW* tile = reinterpret_cast<const TW*>(ws.acquire());
      clk.mark(kClockWeights);
      const int k0 = ch * g.kc, klen = min(g.kc, g.K - k0);
      if (unit < U) mma_tile<TW>(c, tile + (size_t)unit * 8 * klen, klen, x + k0, g.K, B,
                                 member, G);
      __syncthreads();
      ws.release();
    }
    if (unit < U && (lane >> 2) < B) {
      float* out = gred + (unit * G + member) * 64 + (lane >> 2) * 8 + 2 * (lane & 3);
      out[0] = c[0];
      out[1] = c[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= outs) continue;
      const int u = e / (8 * B), b = e / 8 % B, col = e % 8;
      float sum = 0.f;
      for (int m = 0; m < G; ++m) sum += gred[(u * G + m) * 64 + b * 8 + col];
      epi(b, col0 + u * 8 + col, sum, p[i]);
    }
    __syncthreads();
  }
}

// The float32-weight matmul phase: y[b, j] = sum_k xs[b*K + k] * w[j*K + k]
// for the B rows and the N output columns of an output-major (N, K) weight,
// weights loaded directly; epi(b, j, y, pre(b, j)) once for each. Column
// groups of 4 go to G warps each (G warps split K), G as large as the grid's
// warps allow; a block takes kWarps / G groups per round. Partial sums are
// combined in a fixed order. Every thread of every block calls it.
template <typename Prep, typename PreFn, typename Epi>
__device__ __forceinline__ void gemv_phase(const float* xs, const float* __restrict__ w, int K,
                                           int N, int B, float* gred, StepClock& clk, int phase,
                                           Prep prepare, PreFn pre, Epi epi) {
  constexpr int VN = 4, NC = 4;
  clk.mark(phase);
  prepare();
  clk.mark(kClockInputs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = N / NC;
  const int chunk = 32 * VN;
  const int chunks = (K + chunk - 1) / chunk;
  const int total_warps = gridDim.x * kWarps;
  int G = 1;
  while (G < kWarps && 2 * G <= chunks && (long long)groups * 2 * G <= total_warps) G *= 2;
  const int per_block = kWarps / G;
  const int slot = warp / G, member = warp % G;
  const int rounds = (groups + per_block * gridDim.x - 1) / (per_block * gridDim.x);
  for (int round = 0; round < rounds; ++round) {
    const int first = (round * gridDim.x + blockIdx.x) * per_block;
    const int group = first + slot;
    float acc[NC][kMaxBatch];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) acc[c][b] = 0.f;
    if (group < groups) {
      const float* wg = w + (size_t)group * NC * K;
      for (int ci = member; ci < chunks; ci += G) {
        const int k = ci * chunk + lane * VN;
        if (k >= K) continue;
        float wv[NC][VN];
#pragma unroll
        for (int c = 0; c < NC; ++c) Vec<float>::load(wg + (size_t)c * K + k, wv[c]);
#pragma unroll
        for (int b = 0; b < kMaxBatch; ++b) {
          if (b >= B) break;
          const float4 x4 = *reinterpret_cast<const float4*>(xs + (size_t)b * K + k);
          const float xv[VN] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int i = 0; i < VN; ++i) acc[c][b] = fmaf(xv[i], wv[c][i], acc[c][b]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= B) break;
        float v = acc[c][b];
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) gred[(warp * NC + c) * kMaxBatch + b] = v;
      }
    __syncthreads();
    for (int t = threadIdx.x; t < per_block * NC * B; t += kThreads) {
      const int s = t / (NC * B), c = (t / B) % NC, b = t % B;
      if (first + s >= groups) continue;
      float sum = 0.f;
      for (int m = 0; m < G; ++m) sum += gred[((s * G + m) * NC + c) * kMaxBatch + b];
      const int j = (first + s) * NC + c;
      epi(b, j, sum, pre(b, j));
    }
    __syncthreads();
  }
}

// LayerNorm of B rows of E floats in shared memory, over the whole block:
// each row gets kWarps / B' warps (B' = B rounded up to a power of two), so
// at B = 1 all 16 warps share the row. y = (x - mean) * rsqrt(var + eps)
// [* scale + bias]; out (may be null) receives y, xw y as A.
template <typename A>
__device__ void rows_layer_norm(const float* x, float* out, A* xw, int B, int E, float eps,
                                const float* scale, const float* bias, float* red) {
  int rows = 1;
  while (rows < B) rows *= 2;
  const int per_row = kWarps / rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / per_row, first = (warp % per_row) * 32 + lane, stride = per_row * 32;
  const float* xr = x + (size_t)r * E;
  float s = 0.f;
  if (r < B)
    for (int e = first; e < E; e += stride) s += xr[e];
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float mean = 0.f;
  for (int i = 0; i < per_row && r < B; ++i) mean += red[r * per_row + i];
  mean /= E;
  float q = 0.f;
  if (r < B)
    for (int e = first; e < E; e += stride) {
      const float c = xr[e] - mean;
      q += c * c;
    }
  for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  __syncthreads();
  if (lane == 0) red[warp] = q;
  __syncthreads();
  float var = 0.f;
  for (int i = 0; i < per_row && r < B; ++i) var += red[r * per_row + i];
  const float rs = rsqrtf(var / E + eps);
  if (r < B)
    for (int e = first; e < E; e += stride) {
      float y = (xr[e] - mean) * rs;
      if (scale != nullptr) y = y * scale[e] + bias[e];
      if (out != nullptr) out[(size_t)r * E + e] = y;
      xw[(size_t)r * E + e] = from_f<A>(y);
    }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Layouts.

// The float32 scratch of a launch, in this order: x1, q, x2 and h (B x E
// each), the attention output (B x E, held as A), the MLP hidden (B x 4E,
// held as A), the logits (B x V), the attention partials (B x H x
// kMaxSplits x (D + 2)); then ints: the B x H split counters and the grid
// barrier's counter. The wrapper zeroes it.
// _scratch_floats in ops/decode_kernel_wide.py mirrors it.
__host__ __device__ inline size_t scratch_floats(int B, int E, int H, int D, int V) {
  return 9 * (size_t)B * E + (size_t)B * V + (size_t)B * H * kMaxSplits * (D + 2) +
         (size_t)B * H + 1;
}

// Floats of a block's attention merge: per thread group (D / VA lanes a
// key, kGroupThreads / lanes groups a warp group) its D sums, max, sum and
// weight; kThreads partial sums of the merge; a (row, head)'s kMaxSplits
// partials (D + 2 each) for the last split's merge; 4 more for the
// last-split flag and the groups' max and sum.
__host__ __device__ inline size_t attention_floats(int D, int va) {
  const size_t groups = (size_t)kGroupsPerBlock * (kGroupThreads / (D / va));
  return groups * (D + 3) + kThreads + (size_t)kMaxSplits * (D + 2) + 4;
}

// The next power of two at or above the padded vocabulary: the length of a
// sampling team's sort.
__host__ __device__ inline int sort_length(int V) {
  int n = 1;
  while (n < V) n *= 2;
  return n;
}

// Bytes of a sampling team's shared memory: its row sorted (sort_length(V)
// floats), the exclusive prefix sums of the sorted exp values (as many
// doubles) and its warps' partial sums (kWarps doubles).
__host__ __device__ inline size_t sample_team_bytes(int V) {
  return (size_t)sort_length(V) * 12 + 8 * kWarps;
}

// Dynamic shared memory of one block, in bytes: the header, a union of the
// phases' operands (LayerNorm's B x E float rows and their B x E operand in
// A; the fp operand, B x 4E in A; the attention merge; the sampling teams'
// sorts), 128-aligned, and, for bf16
// and int8 weights, the two weight stages. wide_smem_bytes() in
// ops/decode_kernel_wide.py mirrors it.
__host__ __device__ inline size_t smem_bytes(int B, int E, int D, int V, int wbytes,
                                             int abytes) {
  size_t u = (size_t)B * E * (4 + abytes);
  const size_t fp = (size_t)4 * B * E * abytes;
  const size_t attn = 4 * attention_floats(D, 16 / abytes);
  const size_t sample = (size_t)B * sample_team_bytes(V);
  if (fp > u) u = fp;
  if (attn > u) u = attn;
  if (sample > u) u = sample;
  u = (u + 127) / 128 * 128;
  return kHeaderBytes + u + (wbytes != 4 ? 2 * (size_t)kStageBytes : 0);
}

// ---------------------------------------------------------------------------
// The step.

// The step's active rows, the same in every block (shared memory): per row
// its slot, its position (embedding row, K/V write row), the position its
// keys end at (key count key_pos + 1, the relative band's alignment),
// whether it writes its K/V row, its key splits and its first attention
// item; and each slot's next input token.
struct RowList {
  int count;
  int tok[kMaxBatch];
  int slot[kMaxBatch], pos[kMaxBatch], key_pos[kMaxBatch], write[kMaxBatch];
  int splits[kMaxBatch], item0[kMaxBatch + 1];
};
static_assert(sizeof(RowList) + 16 <= kGeomOffset, "row list outgrows its header slot");
static_assert(kGeomOffset + 5 * sizeof(TileGeom) <= kInfoBytes, "tile geometry outgrows its slot");

// Key splits per active row: enough (row, head, split) items to cover the
// grid's blocks, at most one for every kMinSplitKeys keys (so none is
// empty), at most kMaxSplits. Thread 0 calls it. wide_attention_items in
// ops/decode_kernel_wide.py mirrors it.
__device__ inline void plan_splits(RowList& R, int H) {
  const int B = R.count;
  int cap = B > 0 ? (int)gridDim.x / (B * H) : 1;
  cap = cap < 1 ? 1 : (cap > kMaxSplits ? kMaxSplits : cap);
  R.item0[0] = 0;
  for (int r = 0; r < B; ++r) {
    const int S = min((R.key_pos[r] + kMinSplitKeys) / kMinSplitKeys, cap);
    R.splits[r] = S;
    R.item0[r + 1] = R.item0[r] + H * S;
  }
}

// Everything a launch reads and writes; unused pointers are null.
template <typename W, typename A>
struct WideArgs {
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
  A* kv;                   // float K/V: (L, 2, slots, C, E)
  int8_t* kq;              // decode_wide's int8 K/V: (L, 2, slots, C, E)
  float* ks;               // (L, 2, slots, C)
  A* tail;                 // (L, 2, slots, kTail, E)
  const int* prompts;      // (slots, P)
  const int* plens;        // (slots,)
  const float* temps;      // (slots,)
  const float* topk;       // (slots,), Vpad+1 = off
  const float* topp;       // (slots,), 2.0 = off
  int* tokens;             // decode_wide (slots, out_len); segment (slots, steps)
  float* logits_out;       // decode_wide: (slots, Vpad) last step's logits, or null
  int* carry;              // segment: (slots,) next input, carried
  const int* starts;       // segment: (slots,) global step of position 0
  unsigned long long* clock;  // (9,) or null
  // Scratch, in scratch_floats()'s order, indexed by active row.
  float* x1;               // (B, E) ln_1 output (the residual's base)
  float* q;                // (B, E) q rounded to A
  float* x2;               // (B, E)
  float* h;                // (B, E) residual stream
  A* attn;                 // (B, E) attention output
  A* hid;                  // (B, 4E) GELU output
  float* logits;           // (B, Vpad)
  float* part;             // (B, H, kMaxSplits, D + 2): acc[D], max, sum
  int* count;              // (B, H) finished splits
  unsigned* barrier;       // grid barrier counter
  int slots, prompt_width, layers, heads, head_dim, embed, cache_len, window, vocab_pad;
  int num_steps, out_len;  // decode_wide: steps; out_len. segment: steps, steps
  int step0, live, use_rel;
  unsigned seed;
  float softmax_scale, eps;

  // Points the scratch fields into one buffer laid out as scratch_floats().
  __host__ void bind_scratch(float* s) {
    const size_t BE = (size_t)slots * embed;
    x1 = s;
    q = x1 + BE;
    x2 = q + BE;
    h = x2 + BE;
    attn = reinterpret_cast<A*>(h + BE);
    hid = reinterpret_cast<A*>(h + 2 * BE);
    logits = h + 6 * BE;
    part = logits + (size_t)slots * vocab_pad;
    count = reinterpret_cast<int*>(part + (size_t)slots * heads * kMaxSplits * (head_dim + 2));
    barrier = reinterpret_cast<unsigned*>(count + (size_t)slots * heads);
  }
};

// The shared memory of a block, carved from the dynamic buffer.
struct Smem {
  uint64_t* bars;  // [2]
  RowList* rows;
  TileGeom* geom;  // [5]
  float* red;      // 64
  float* gred;     // kGredFloats
  char* u;         // the union
  char* stages;    // [2][kStageBytes], bf16 and int8 weights
  __device__ Smem(unsigned char* base, size_t union_bytes)
      : bars(reinterpret_cast<uint64_t*>(base)),
        rows(reinterpret_cast<RowList*>(base + 16)),
        geom(reinterpret_cast<TileGeom*>(base + kGeomOffset)),
        red(reinterpret_cast<float*>(base + kInfoBytes)),
        gred(red + 64),
        u(reinterpret_cast<char*>(base + kHeaderBytes)),
        stages(reinterpret_cast<char*>(base + kHeaderBytes + union_bytes)) {}
};

// VA elements of a K/V or band row in one 16-byte word, converted on use.
template <typename A> struct Row16;
template <> struct Row16<float> {
  using V = float4;
  static __device__ __forceinline__ V cg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ V ro(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float at(const V& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <> struct Row16<__nv_bfloat16> {
  using V = uint4;
  static __device__ __forceinline__ V cg(const __nv_bfloat16* p) {
    return __ldcg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ V ro(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // Element c (lower element in the lower half of each word): a bf16's bits
  // are a float's upper half.
  static __device__ __forceinline__ float at(const V& v, int c) {
    const unsigned w = c < 2 ? v.x : c < 4 ? v.y : c < 6 ? v.z : v.w;
    return __uint_as_float(c % 2 ? w & 0xffff0000u : w << 16);
  }
};

// P2 for one layer: the block's (row, head, key split) items. The block's
// warp groups take quarters of the split's keys; in each, a thread group of
// D / VA lanes holds a key's head (VA elements a lane) and walks its keys
// with an online softmax (one max, sum and VA sums of the AV product per
// lane). The block's thread groups merge in order in shared memory; a
// (row, head) of one split writes its output, several splits write partials
// (acc, max, sum) and the last to finish merges them in split order.
template <typename W, typename A, bool KVQ>
__device__ __forceinline__ void attention_phase(const WideArgs<W, A>& a, const RowList& R,
                                                float* u, int layer, StepClock& clk) {
  constexpr int VA = Vec<A>::N;
  const int E = a.embed, H = a.heads, D = a.head_dim, C = a.cache_len, Wn = a.window;
  const int lanes = D / VA, groups = kGroupThreads / lanes, all = kGroupsPerBlock * groups;
  const int tid = threadIdx.x, wg = tid / kGroupThreads, wt = tid % kGroupThreads;
  const int gl = wt % lanes, grp = wg * groups + wt / lanes;
  float* const gacc = u;                          // [all][D]
  float* const gm = gacc + (size_t)all * D;       // [all]
  float* const gsum = gm + all;                   // [all]
  float* const gw = gsum + all;                   // [all]
  float* const psum = gw + all;                   // [kThreads]
  float* const ps = psum + kThreads;              // [kMaxSplits][D + 2]
  int* const flag = reinterpret_cast<int*>(ps + kMaxSplits * (D + 2));
  float* const stats = reinterpret_cast<float*>(flag + 1);  // max, sum
  const int warp = tid >> 5, lane = tid & 31, parts = kThreads / D;
  const int items = R.item0[R.count];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int b = 0;
    while (item >= R.item0[b + 1]) ++b;
    const int S = R.splits[b], local = item - R.item0[b];
    const int hh = local / S, s = local - hh * S;
    const int key_pos = R.key_pos[b], n = key_pos + 1;
    const int per = (n + S - 1) / S, j0 = s * per, j1 = min(n, j0 + per);
    const int quarter = (j1 - j0 + kGroupsPerBlock - 1) / kGroupsPerBlock;
    const int k0 = min(j1, j0 + wg * quarter), k1 = min(j1, k0 + quarter);
    const int flushed = R.pos[b] / kTail * kTail;
    const size_t kline = (size_t)layer * 2 * a.slots + R.slot[b], vline = kline + a.slots;
    const int off = hh * D + gl * VA;
    clk.mark(1);
    float q[VA];
#pragma unroll
    for (int c = 0; c < VA; c += 4) Load<float, 4>::cg(a.q + (size_t)b * E + off + c, q + c);
    float m = -CUDART_INF_F, l = 0.f, acc[VA];
#pragma unroll
    for (int c = 0; c < VA; ++c) acc[c] = 0.f;
    // Every lane of a warp group runs the same rounds (the lane-group
    // shuffles need whole warps); a lane past its quarter's end idles.
#pragma unroll 4
    for (int base = k0; base < k1; base += groups) {
      const int j = base + wt / lanes;
      const bool valid = j < k1;
      const int jj = valid ? j : k0;
      // Float K/V stay 16-byte words until used (fewer registers with four
      // keys in flight); int8 K/V convert as they load.
      typename Row16<A>::V kr, vr, br;
      float kv[VA], vv[VA];
      float kscale = 1.f, vscale = 1.f;
      if constexpr (KVQ) {
        if (jj < flushed) {
          Load<int8_t, VA>::cg(a.kq + (kline * C + jj) * E + off, kv);
          Load<int8_t, VA>::cg(a.kq + (vline * C + jj) * E + off, vv);
          kscale = __ldcg(a.ks + kline * C + jj);
          vscale = __ldcg(a.ks + vline * C + jj);
        } else {
          Load<A, VA>::cg(a.tail + (kline * kTail + jj % kTail) * E + off, kv);
          Load<A, VA>::cg(a.tail + (vline * kTail + jj % kTail) * E + off, vv);
        }
      } else {
        kr = Row16<A>::cg(a.kv + (kline * C + jj) * E + off);
        vr = Row16<A>::cg(a.kv + (vline * C + jj) * E + off);
      }
      // Slot jj is at distance key_pos - jj: table row window-1-(key_pos-jj);
      // rows outside the table give no bias. Added before scaling.
      const int r = Wn - 1 - (key_pos - jj);
      const bool banded = a.use_rel && r >= 0;
      if (banded) br = Row16<A>::ro(a.rel + ((size_t)layer * Wn + r) * E + off);
      auto key = [&](int c) { return KVQ ? kv[c] : Row16<A>::at(kr, c); };
      auto value = [&](int c) { return KVQ ? vv[c] : Row16<A>::at(vr, c); };
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < VA; ++c) part = fmaf(q[c], key(c), part);
      part *= kscale;
      if (banded) {
#pragma unroll
        for (int c = 0; c < VA; ++c) part = fmaf(q[c], Row16<A>::at(br, c), part);
      }
      for (int o = lanes / 2; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (valid) {
        const float sc = part * a.softmax_scale;
        const float mn = fmaxf(m, sc);
        const float corr = expf(m - mn), p = expf(sc - mn);
        l = l * corr + p;
        const float pv = p * vscale;
#pragma unroll
        for (int c = 0; c < VA; ++c) acc[c] = fmaf(pv, value(c), acc[c] * corr);
        m = mn;
      }
    }
    clk.mark(kClockKeys);
    if (gl == 0) {
      gm[grp] = m;
      gsum[grp] = l;
    }
#pragma unroll
    for (int c = 0; c < VA; ++c) gacc[grp * D + gl * VA + c] = acc[c];
    __syncthreads();
    // The block's thread groups merge in a fixed order: warp 0 takes their
    // max and weighted sum (lane-strided, then a shuffle tree); thread
    // (d, part) of D x parts sums the weighted accs of every parts-th group,
    // and thread d the parts in order.
    if (warp == 0) {
      float mx = -CUDART_INF_F;
      for (int k = lane; k < all; k += 32) mx = fmaxf(mx, gm[k]);
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float dn = 0.f;
      for (int k = lane; k < all; k += 32) {
        const float w = expf(gm[k] - mx);
        gw[k] = w;
        dn += gsum[k] * w;
      }
      for (int o = 16; o; o >>= 1) dn += __shfl_xor_sync(0xffffffffu, dn, o);
      if (lane == 0) {
        stats[0] = mx;
        stats[1] = dn;
      }
    }
    __syncthreads();
    {
      const int d = tid % D, part = tid / D;
      float num = 0.f;
      for (int k = part; k < all; k += parts) num += gacc[k * D + d] * gw[k];
      psum[tid] = num;
    }
    __syncthreads();
    const float M = stats[0], den = stats[1];
    auto merged = [&](int d) {
      float num = 0.f;
      for (int part = 0; part < parts; ++part) num += psum[part * D + d];
      return num;
    };
    const size_t head = (size_t)b * H + hh;
    if (S == 1) {
      for (int d = tid; d < D; d += kThreads)
        a.attn[(size_t)b * E + hh * D + d] = from_f<A>(merged(d) / den);
    } else {
      float* out = a.part + (head * kMaxSplits + s) * (D + 2);
      for (int d = tid; d < D; d += kThreads) out[d] = merged(d);
      if (tid == 0) {
        out[D] = M;
        out[D + 1] = den;
      }
      __syncthreads();
      if (tid == 0) {
        acq_rel_fence();
        *flag = atomicAdd(a.count + head, 1) == S - 1;
      }
      __syncthreads();
      if (*flag) {
        // The last split: every split's partial is written. Bring them into
        // shared memory at once, then merge in split order: weights
        // exp(m_s - max), the sum of the l_s so weighted.
        acq_rel_fence();
        const float* p = a.part + head * kMaxSplits * (D + 2);
        for (int i = tid; i < S * (D + 2); i += kThreads) ps[i] = __ldcg(p + i);
        __syncthreads();
        for (int d = tid; d < D; d += kThreads) {
          float mx = -CUDART_INF_F;
          for (int t = 0; t < S; ++t) mx = fmaxf(mx, ps[t * (D + 2) + D]);
          float total = 0.f, num = 0.f;
          for (int t = 0; t < S; ++t) {
            const float w = expf(ps[t * (D + 2) + D] - mx);
            total += ps[t * (D + 2) + D + 1] * w;
            num += ps[t * (D + 2) + d] * w;
          }
          a.attn[(size_t)b * E + hh * D + d] = from_f<A>(num / total);
        }
        if (tid == 0) a.count[head] = 0;
      }
    }
    __syncthreads();
    clk.mark(kClockMerge);
  }
}

// The sample of every active row, a team of warps a row, in every block: the
// token sample_row (decode_common.cuh) draws from the same logits. temp <= 0:
// the first argmax. Else logits * (1 / temp); top-k keeps a lane whose count
// of strictly greater lanes is below k, top-p one whose mass of strictly
// greater lanes (exp(x - max), summed in double) is below p of the total, both
// on the unfiltered scaled row; then the Philox Gumbel noise of (seed, step,
// slot) and the first argmax. A filtering team sorts its row (bitonic, in
// shared memory u, sample_team_bytes(V) a row) and reads each lane's count
// and mass off the sorted row by binary search, where sample_row compares
// every pair of lanes. Row b's token lands in out[b]; every thread of the
// block calls it.
__device__ void sample_rows(const float* logits, const RowList& R, const float* temps,
                            const float* topk, const float* topp, int V, unsigned seed,
                            unsigned step, char* u, float* scratch, int* out) {
  const int B = R.count, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int rows = 1;
  while (rows < B) rows *= 2;
  const int per = kWarps / rows, b = warp / per, member = warp % per;
  const int T = per * 32, tt = member * 32 + lane, n = sort_length(V);
  float best = -CUDART_INF_F;
  int index = V;
  if (b < B) {
    const int slot = R.slot[b];
    const float temp = temps[slot];
    const float* lg = logits + (size_t)b * V;
    const bool noisy = temp > 0.f;
    const float inv_temp = noisy ? 1.0f / temp : 1.f;
    const float k = topk[slot], p = topp[slot];
    const bool do_k = noisy && k < (float)V, do_p = noisy && p < 1.0f;
    float* const srt = reinterpret_cast<float*>(u + (size_t)b * sample_team_bytes(V));
    double* const pre = reinterpret_cast<double*>(srt + n);
    double* const tot = pre + n;
    const int team = 1 + b;  // named barrier of the team's T threads
    auto team_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(team), "r"(T) : "memory"); };
    double z = 0.0;
    if (do_k || do_p) {
      for (int v = tt; v < n; v += T)
        srt[v] = v < V ? __fmul_rn(__ldcg(lg + v), inv_temp) : -CUDART_INF_F;
      team_sync();
      // Bitonic sort, descending.
      for (int size = 2; size <= n; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int i = tt; i < n; i += T) {
            const int j = i ^ stride;
            if (j > i) {
              const float x = srt[i], y = srt[j];
              if ((i & size) == 0 ? x < y : x > y) {
                srt[i] = y;
                srt[j] = x;
              }
            }
          }
          team_sync();
        }
      if (do_p) {
        // Exclusive prefix sums of exp(x - max) over the sorted row, in
        // double: a contiguous chunk a thread, its warp's shuffle scan, the
        // warps' totals in order.
        const float m = srt[0];
        const int chunk = n >= T ? n / T : 1, first = min(tt * chunk, n);
        const int last = min(first + chunk, n);
        double own = 0.0;
        for (int i = first; i < last; ++i) own += (double)expf(srt[i] - m);
        double incl = own;
        for (int o = 1; o < 32; o <<= 1) {
          const double up = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += up;
        }
        if (lane == 31) tot[member] = incl;
        team_sync();
        double base = 0.0;
        for (int w = 0; w < member; ++w) base += tot[w];
        for (int w = 0; w < per; ++w) z += tot[w];
        double run = base + incl - own;
        for (int i = first; i < last; ++i) {
          pre[i] = run;
          run += (double)expf(srt[i] - m);
        }
        team_sync();
      }
    }
    for (int c = tt; c < V / 4; c += T) {
      const float4 x4 = __ldcg(reinterpret_cast<const float4*>(lg) + c);
      float x[4] = {x4.x, x4.y, x4.z, x4.w};
      if (noisy) {
        const uint4 r = philox4x32_10(make_uint4((unsigned)c, step, (unsigned)slot, 0u),
                                      make_uint2(seed, 0u));
        const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float scored = __fmul_rn(x[i], inv_temp);
          if (do_k || do_p) {
            int lo = 0, hi = n;  // the lanes strictly above scored
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (srt[mid] > scored) lo = mid + 1; else hi = mid;
            }
            bool keep = !do_k || (float)lo < k;
            if (do_p) keep = keep && pre[lo] / z < (double)p;
            if (!keep) scored = kNegInf;
          }
          x[i] = __fadd_rn(scored, gumbel(words[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x[i] > best) {
          best = x[i];
          index = 4 * c + i;
        }
    }
  }
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, index, o);
    if (ob > best || (ob == best && oi < index)) {
      best = ob;
      index = oi;
    }
  }
  int* scratch_i = reinterpret_cast<int*>(scratch + kWarps);
  if (lane == 0) {
    scratch[warp] = best;
    scratch_i[warp] = index;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    const int r = threadIdx.x;
    float vb = scratch[r * per];
    int vi = scratch_i[r * per];
    for (int w = 1; w < per; ++w) {
      const float ob = scratch[r * per + w];
      const int oi = scratch_i[r * per + w];
      if (ob > vb || (ob == vb && oi < vi)) {
        vb = ob;
        vi = oi;
      }
    }
    out[r] = vi;
  }
  __syncthreads();
}

// What differs between the two kernels at the end of a step: where a sample
// goes (the segment kernel's column j; decode_wide's from the row's
// position), the Philox step of the noise and whether the last step's logits
// are kept.
struct StepOut {
  int j;                 // the step's index in this launch
  unsigned noise_step;   // Philox counter word: decode_wide the position,
                         // the segment kernel the global step
  bool keep_logits;      // decode_wide's last step with logits_out
  bool segment;
};

// One decode step of the active rows R (filled by the caller, with their
// splits planned), for every block: P1-P7 of decode_wide.cu's description
// above, with the weight stream ws (bf16 and int8 weights), the grid
// barrier gb and the clock clk. Leaves each active slot's next input in
// R.tok.
template <typename W, typename A, bool KVQ>
__device__ __forceinline__ void wide_step(const WideArgs<W, A>& a, const Smem& sm,
                                          WeightStream<W, A>& ws, GridBarrier& gb, StepClock& clk,
                                          const StepOut& so) {
  constexpr bool kStreamed = !std::is_same<W, float>::value;
  RowList& R = *sm.rows;
  const int B = R.count, E = a.embed, V = a.vocab_pad, L = a.layers, Wn = a.window;
  const int C = a.cache_len, tid = threadIdx.x;
  const bool quantized = a.wscale != nullptr;
  constexpr int VA = Vec<A>::N;
  float* const rows = reinterpret_cast<float*>(sm.u);            // B x E floats
  A* const xs_ln = reinterpret_cast<A*>(sm.u + (size_t)B * E * 4);  // B x E after them
  A* const xs0 = reinterpret_cast<A*>(sm.u);                      // P3 / P5 operand

  auto sync = [&](int phase) {
    gb.arrive();
    clk.mark(phase);
    gb.wait();
    clk.mark(kClockWait);
    clk.count();
  };
  // One matmul phase: the streamed tiles on tensor cores, or the float32
  // weights' direct loads.
  auto matmul = [&](int kind, const W* w, const A* x, int K, int N, auto prepare, auto pre,
                    auto epi) {
    constexpr int kPhase[5] = {0, 2, 3, 4, 5};  // by MatmulKind
    if constexpr (kStreamed) {
      if (kind == kLogits)
        mma_phase<A>(ws, kind, x, B, sm.gred, clk, kPhase[kind], prepare, pre, epi);
      else
        mma_phase<W>(ws, kind, x, B, sm.gred, clk, kPhase[kind], prepare, pre, epi);
    } else {
      gemv_phase(x, w, K, N, B, sm.gred, clk, kPhase[kind], prepare, pre, epi);
    }
  };
  // Waits for the rows' copy, then their LayerNorm into xs_ln.
  auto ln_rows = [&](float* out, const float* scale, const float* bias) {
    return [&, out, scale, bias]() {
      cp_async_wait_all();
      __syncthreads();
      rows_layer_norm<A>(rows, out, xs_ln, B, E, a.eps, scale, bias, sm.red);
    };
  };
  auto operand_ready = []() {
    cp_async_wait_all();
    __syncthreads();
  };

  for (int layer = 0; layer < L; ++layer) {
    const W* big = a.big_w + (size_t)layer * 8 * E * E;
    const float* wsc = quantized ? a.wscale + (size_t)layer * 8 * E : nullptr;

    // P1: ln_1 and the qkv columns; k, v to the cache at row pos.
    if (layer == 0) {
#pragma unroll 2
      for (int i = tid * VA; i < B * E; i += kThreads * VA) {
        const int b = i / E, e = i - b * E;
        const int pos = R.pos[b];
        float t[VA], p[VA];
        Load<A, VA>::ro(a.wte + (size_t)R.tok[R.slot[b]] * E + e, t);
        Load<A, VA>::ro(a.wpe + (size_t)(pos < Wn - 1 ? pos : Wn - 1) * E + e, p);
#pragma unroll
        for (int c = 0; c < VA; ++c) rows[i + c] = t[c] + p[c];
      }
    } else {
      copy_async(rows, a.h, B * E * 4);
    }
    {
      const float* ln1 = a.ln1 + (size_t)layer * 2 * E;
      const float* bias = a.qkv_b + (size_t)layer * 3 * E;
      matmul(kQkv, big, xs_ln, E, 3 * E,
             ln_rows(blockIdx.x == 0 ? a.x1 : nullptr, ln1, ln1 + E),
             [&](int, int j) { return Pre{wsc != nullptr ? wsc[j] : 1.f, bias[j], 0.f}; },
             [&](int b, int j, float y, Pre p) {
               const float v = (wsc != nullptr ? y * p.scale : y) + p.bias;
               if (j < E) {
                 a.q[b * E + j] = round_to<A>(v);
                 return;
               }
               if (!R.write[b]) return;  // a lingering row writes nothing
               const int which = j < 2 * E ? 0 : 1, e = j - E - which * E;
               const size_t line = ((size_t)layer * 2 + which) * a.slots + R.slot[b];
               if constexpr (KVQ) {
                 a.tail[(line * kTail + R.pos[b] % kTail) * E + e] = from_f<A>(v);
               } else {
                 a.kv[(line * C + R.pos[b]) * E + e] = from_f<A>(v);
               }
             });
    }
    sync(0);

    // P2: attention. int8 K/V: first quantize this step's rows (read
    // quantized only from the step their window completes).
    if constexpr (KVQ) {
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = blockIdx.x * kWarps + warp; r < 2 * B; r += gridDim.x * kWarps) {
        const int b = r % B, which = r / B;
        const size_t line = ((size_t)layer * 2 + which) * a.slots + R.slot[b];
        const int pos = R.pos[b];
        const A* src = a.tail + (line * kTail + pos % kTail) * E;
        float m = 0.f;
#pragma unroll 4
        for (int e = lane * VA; e < E; e += 32 * VA) {
          float v[VA];
          Load<A, VA>::cg(src + e, v);
#pragma unroll
          for (int c = 0; c < VA; ++c) m = fmaxf(m, fabsf(v[c]));
        }
        for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        m = fmaxf(m, 1e-12f);
        const float inv = 127.0f / m;
        int8_t* dst = a.kq + (line * C + pos) * E;
#pragma unroll 4
        for (int e = lane * VA; e < E; e += 32 * VA) {
          float v[VA];
          Load<A, VA>::cg(src + e, v);
#pragma unroll
          for (int c = 0; c < VA; ++c)
            dst[e + c] = (int8_t)fminf(fmaxf(rintf(v[c] * inv), -127.f), 127.f);
        }
        if (lane == 0) a.ks[line * C + pos] = m * (1.0f / 127.0f);
      }
    }
    attention_phase<W, A, KVQ>(a, R, reinterpret_cast<float*>(sm.u), layer, clk);
    sync(1);

    // P3: the attention-proj columns and the residual on x1.
    copy_async(xs0, a.attn, B * E * (int)sizeof(A));
    {
      const float* bias = a.proj_b + (size_t)layer * E;
      matmul(kProj, big + (size_t)3 * E * E, xs0, E, E, operand_ready,
             [&](int b, int j) {
               return Pre{wsc != nullptr ? wsc[3 * E + j] : 1.f, bias[j],
                          __ldcg(a.x1 + b * E + j)};
             },
             [&](int b, int j, float y, Pre p) {
               const float v = (wsc != nullptr ? y * p.scale : y) + p.bias;
               a.x2[b * E + j] = p.resid + v;
             });
    }
    sync(2);

    // P4: ln_2 (folded into fc) and the GELU of the fc columns.
    copy_async(rows, a.x2, B * E * 4);
    {
      const float* bias = a.fc_b + (size_t)layer * 4 * E;
      matmul(kFc, big + (size_t)4 * E * E, xs_ln, E, 4 * E,
             ln_rows(nullptr, nullptr, nullptr),
             [&](int, int j) { return Pre{wsc != nullptr ? wsc[4 * E + j] : 1.f, bias[j], 0.f}; },
             [&](int b, int j, float y, Pre p) {
               const float v = (wsc != nullptr ? y * p.scale : y) + p.bias;
               a.hid[(size_t)b * 4 * E + j] = from_f<A>(gelu_tanh(v));
             });
    }
    sync(3);

    // P5: the mlp-proj columns and the residual on x2.
    copy_async(xs0, a.hid, B * 4 * E * (int)sizeof(A));
    {
      const float* bias = a.fp_b + (size_t)layer * E;
      const float* fsc = quantized ? a.fpscale + (size_t)layer * E : nullptr;
      matmul(kFp, a.fp_w + (size_t)layer * 4 * E * E, xs0, 4 * E, E, operand_ready,
             [&](int b, int j) {
               return Pre{fsc != nullptr ? fsc[j] : 1.f, bias[j], __ldcg(a.x2 + b * E + j)};
             },
             [&](int b, int j, float y, Pre p) {
               const float v = fsc != nullptr ? y * p.scale : y;
               a.h[b * E + j] = (p.resid + v) + p.bias;
             });
    }
    sync(4);
  }

  // P6: tied logits, standardize(h) @ logits_w + logits_b.
  copy_async(rows, a.h, B * E * 4);
  matmul(kLogits, reinterpret_cast<const W*>(a.logits_w), xs_ln, E, V,
         ln_rows(nullptr, nullptr, nullptr),
         [&](int, int j) { return Pre{1.f, a.logits_b[j], 0.f}; },
         [&](int b, int j, float y, Pre p) { a.logits[(size_t)b * V + j] = y + p.bias; });
  sync(5);

  // P7: sampling; each active slot's next input to R.tok.
  auto next_input = [&](int b, int token) {
    const int slot = R.slot[b], pos = R.pos[b];
    const int plen = min(max(a.plens[slot], 1), a.prompt_width);
    return pos + 1 < plen ? a.prompts[slot * a.prompt_width + pos + 1] : token;
  };
  auto emit = [&](int b, int token) {
    const int slot = R.slot[b];
    if (so.segment) {
      a.tokens[(size_t)slot * a.num_steps + so.j] = token;
    } else {
      const int col = R.pos[b] - a.plens[slot] + 1;
      if (col >= 0 && col < a.out_len) a.tokens[(size_t)slot * a.out_len + col] = token;
    }
  };
  if (so.keep_logits && blockIdx.x == 0)
    for (int v = tid; v < B * V; v += kThreads)
      a.logits_out[(size_t)R.slot[v / V] * V + v % V] = __ldcg(a.logits + v);
  // Every block samples every row: no barrier.
  int* sampled = reinterpret_cast<int*>(sm.gred + 2 * kWarps);
  sample_rows(a.logits, R, a.temps, a.topk, a.topp, V, a.seed, so.noise_step, sm.u, sm.gred,
              sampled);
  if (tid < B) {
    if (blockIdx.x == 0) emit(tid, sampled[tid]);
    R.tok[R.slot[tid]] = next_input(tid, sampled[tid]);
  }
  __syncthreads();
  clk.mark(6);
}

// The launch shared by both kernels: shared memory, residency (every block
// must be resident at once, or the first grid barrier never opens: such a
// grid is refused), cooperative launch.
template <typename Kernel, typename Args>
int launch_cooperative(Kernel kernel, Args& a, size_t smem, int device, int grid,
                       cudaStream_t stream) {
  if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
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
  if (per_sm < 1 || grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Union bytes of smem_bytes (the stages follow it).
__host__ __device__ inline size_t union_bytes(int B, int E, int D, int V, int abytes) {
  return smem_bytes(B, E, D, V, 4, abytes) - kHeaderBytes;
}

// The argument checks both kernels make.
inline bool widths_ok(int batch, int embed, int head_dim) {
  return batch >= 1 && batch <= kMaxBatch && embed % 16 == 0 && head_dim % 8 == 0 &&
         head_dim <= 128 && kThreads % head_dim == 0;
}

}  // namespace decode_wide_common
