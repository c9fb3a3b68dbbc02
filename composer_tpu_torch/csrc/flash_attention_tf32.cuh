// flash_attention_tf32.cuh: the float32 flash attention kernels on the
// tensor cores, forward (flash_forward_tf32_kernel, replacing
// pallas_attention.py _flash_kernel) and backward
// (flash_backward_tf32_kernel, replacing _flash_bwd_kernel), for head_dim
// D = 16, 32, 64 and 128. flash_attention.cu's header states the contract
// and the design; this file is included by it, inside its namespace, after
// flash_attention_mma.cuh, whose staging, atomics and dropout constants it
// shares.
//
// Every product is mma.sync.m16n8k8 in TF32, three times (split TF32): an
// operand x is split into big = tf32(x) and small = tf32(x - big) (tf32:
// cvt.rna, round to nearest with ties away from zero, 10 mantissa bits),
// and a b is accumulated in float32 as big_a small_b + small_a big_b +
// big_a big_b, smallest terms first. The dropped small_a small_b is below
// float32's own rounding, so the products keep float32 accuracy. Fragment
// names follow the PTX m16n8k8 layouts: lane = 4 g + t; an A fragment holds
// rows g, g+8 at columns t, t+4; a B fragment rows (k) t, t+4 of column g;
// a C fragment rows g, g+8 at columns 2t, 2t+1.
//
// Where an operand comes from a C fragment (P and dS^T) the depth of the
// product is permuted inside each 8-wide step: A column t stands for depth
// 2t and column t+4 for 2t+1, so the C fragment is the A fragment as it
// lies, and the B operand reads rows 2t and 2t+1, which the pitch D+4
// keeps free of bank conflicts. The staged dS is stored with the same
// permutation (ds_col) for the dq product.

constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
// Floats per row of the staged dS [query][key]: rows 2t apart land on
// distinct banks for the column-permuted stores, rows g apart for the reads.
constexpr int kDsF32Pitch = kBlock + 4;

// Floats per row of a staged float32 tile: D + 4, so that rows g apart
// (g = 0..7) at columns t and rows 2t apart at column g are on distinct banks.
template <int D>
__host__ __device__ constexpr int f32_pitch() {
  return D + 4;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero: half a unit of the 13 dropped bits added to the
// magnitude, then those bits cleared), in two integer operations: with the
// instruction itself the kernels take 1.08-1.31x (forward) and 1.16-1.59x
// (backward) the time on the card (PERF.md, scripts/flash_f32_variants.py).
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

struct SplitA {
  unsigned big[4], small[4];
};

// An A fragment (a0 row g col t, a1 row g+8 col t, a2 row g col t+4, a3
// row g+8 col t+4) split into its big and small TF32 parts.
__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  const float x[4] = {a0, a1, a2, a3};
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.big[i] = to_tf32(x[i]);
    s.small[i] = to_tf32(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

// The A fragment of a row-major tile at p = tile + (r0 + g) * pitch + k0 + t.
__device__ __forceinline__ SplitA load_a(const float* p, int pitch) {
  return split_a(p[0], p[8 * pitch], p[4], p[8 * pitch + 4]);
}

// c += a b: a 16x8 TF32 (row), b 8x8 TF32 (col), c 16x8 float32.
__device__ __forceinline__ void mma1688(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, smallest first; b0, b1 the float32 B
// fragment (rows t and t+4, or the permuted 2t and 2t+1, of column g).
__device__ __forceinline__ void mma_x3(float (&c)[4], const SplitA& a, float b0, float b1) {
  const unsigned bb0 = to_tf32(b0), bb1 = to_tf32(b1);
  const unsigned bs0 = to_tf32(b0 - __uint_as_float(bb0)), bs1 = to_tf32(b1 - __uint_as_float(bb1));
  mma1688(c, a.big, bs0, bs1);
  mma1688(c, a.small, bb0, bb1);
  mma1688(c, a.big, bb0, bb1);
}

// The C fragment of an 8-column tile as the A fragment of the 8-deep
// product over those columns (depth permuted: column 2t as t, 2t+1 as t+4).
__device__ __forceinline__ SplitA c_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// Rows [first, first+rows) of a [limit, D] float32 matrix into shared
// memory at pitch D+4, zeros for rows outside [0, limit), by the block's
// Threads threads. Issued with cp.async, not committed.
template <int D, int Threads>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int rows, int first,
                                               int limit) {
  constexpr int kChunks = D / 4, P = f32_pitch<D>();
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += Threads) {
    const int r = idx / kChunks, c = idx % kChunks, row = first + r;
    const bool valid = row >= 0 && row < limit;
    cp_async16(dst + r * P + c * 4, src + (size_t)(valid ? row : 0) * D + c * 4, valid);
  }
}

// q.E of one warp's 16 rows (A fragments from the staged rows at q_row =
// tile + (r0 + g) * P + t) against the band rows [e_row0 + 8 N0, e_row0 +
// 8 N1) of the staged band et, into the warp's staging rows qe (16 x
// kBandSlice floats at pitch kQePitch, unskewed). The 8-row tiles [N0, N1)
// are template arguments, so that the loop is specialised, and the depth loop
// is unrolled by 4: in full, the D=128 backward with the bias takes 1.16-1.18x
// the time on the card (PERF.md).
template <int D, int N0 = 0, int N1 = kBandSlice / 8>
__device__ __forceinline__ void band_product_f32(float* qe, const float* q_row, const float* et,
                                                 int e_row0, int lane) {
  constexpr int P = f32_pitch<D>();
  const int g = lane >> 2, t = lane & 3;
  float acc[N1 - N0][4] = {};
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    const SplitA qa = load_a(q_row + 8 * ks, P);
#pragma unroll
    for (int n = 0; n < N1 - N0; ++n) {
      const float* er = et + (e_row0 + 8 * (N0 + n) + g) * P + 8 * ks + t;
      mma_x3(acc[n], qa, er[0], er[4]);
    }
  }
#pragma unroll
  for (int n = 0; n < N1 - N0; ++n) {
    const int col = 8 * (N0 + n) + 2 * t;
    qe[g * kQePitch + col] = acc[n][0];
    qe[g * kQePitch + col + 1] = acc[n][1];
    qe[(g + 8) * kQePitch + col] = acc[n][2];
    qe[(g + 8) * kQePitch + col + 1] = acc[n][3];
  }
}

// Shared memory of the forward: Q, K and V tiles, the dropout words and,
// with the bias only, the band and the staged q.E.
template <int D>
size_t forward_f32_smem(bool use_rel) {
  return sizeof(float) * ((size_t)(3 * kBlock + (use_rel ? kBand : 0)) * f32_pitch<D>() +
                          (use_rel ? kF32Warps * 16 * kQePitch : 0)) +
         sizeof(unsigned) * kF32Warps * 2 * kFwdDropWords;
}

// One block of 4 warps a 64-row q-tile, 16 rows a warp, walking the k-tiles
// at or before the diagonal. Single buffers: K (with the band) and V are
// waited for apart, so that the next K streams in during this tile's
// softmax and P V, the next V during the next tile's scores.
template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_forward_tf32_kernel(const Args a) {
  constexpr int P = f32_pitch<D>(), KS = D / 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* q_s = reinterpret_cast<float*>(f32_smem);  // [64][P]
  float* k_s = q_s + kBlock * P;                      // [64][P]
  float* v_s = k_s + kBlock * P;                      // [64][P]
  // [warp][2][kFwdDropWords] dropout words
  unsigned* drop_s = reinterpret_cast<unsigned*>(v_s + kBlock * P);
  // With the bias only: the band of the k-tile [128][P] and the staged q.E.
  float* e_s = reinterpret_cast<float*>(drop_s + kF32Warps * 2 * kFwdDropWords);
  float* qe_s = e_s + kBand * P;  // [warp][16][kQePitch]

  const int nb = a.seq / kBlock;
  const int ib = nb - 1 - (int)blockIdx.x;  // the longest rows start first
  const int bh = blockIdx.y, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                // the warp's first row in the tile
  const int row_g = ib * kBlock + r0 + g;  // this lane's query rows: row_g, row_g + 8
  const size_t base = (size_t)bh * a.seq * D;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* e_head =
      a.use_rel ? static_cast<const float*>(a.e) + (size_t)h * a.window * D : nullptr;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;
  const float c2 = a.scale * kLog2e;  // scores in the exp2 domain
  float* qe_w = qe_s + warp * 16 * kQePitch;
  unsigned* drop_w = drop_s + warp * 2 * kFwdDropWords;
  const float* q_row = q_s + (r0 + g) * P + t;

  auto stage_k = [&](int jb) {
    stage_rows_f32<D, kF32Threads>(k_s, k, kBlock, jb * kBlock, a.seq);
    if (a.use_rel) {
      stage_rows_f32<D, kF32Threads>(e_s, e_head, kBand, a.window - kBlock - (ib - jb) * kBlock,
                                     a.window);
    }
  };
  stage_rows_f32<D, kF32Threads>(q_s, q, kBlock, ib * kBlock, a.seq);
  stage_k(0);
  cp_async_commit();
  stage_rows_f32<D, kF32Threads>(v_s, v, kBlock, 0, a.seq);
  cp_async_commit();

  float o[NT][4] = {};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // rows g, g+8; l per lane

  for (int jb = 0; jb <= ib; ++jb) {
    // Groups in flight: [Q, K, band of jb], [V of jb]. Every commit below
    // is unconditional (an empty group past the last tile), so that one
    // wait_group 1 always leaves just the newest group in flight.
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4] = {};  // 16 rows x 64 keys
#pragma unroll 4  // in full, 1.18-1.21x the time at D=128 (PERF.md)
    for (int ks = 0; ks < KS; ++ks) {
      const SplitA qa = load_a(q_row + 8 * ks, P);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = k_s + (8 * nt + g) * P + 8 * ks + t;
        mma_x3(s[nt], qa, kr[0], kr[4]);
      }
    }
    if (a.use_rel) {
      // Row r of the warp (tile row r0 + r) and key j need band row
      // 63 - (r0 + r) + j = (48 - r0) + (15 - r + j): one 16 x 80 product,
      // read back skewed.
      band_product_f32<D>(qe_w, q_row, e_s, 48 - r0, lane);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = g + 8 * (c >> 1), j = 8 * nt + 2 * t + (c & 1);
          s[nt][c] += qe_w[r * kQePitch + 15 - r + j];
        }
      }
    }
    __syncthreads();  // every warp has read K and the band (and its own q.E)
    if (jb < ib) stage_k(jb + 1);
    cp_async_commit();

    const bool diag = jb == ib;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + g + 8 * (c >> 1), j = 8 * nt + 2 * t + (c & 1);
        const float x = (diag && j > r) ? kNegInf : s[nt][c] * c2;
        s[nt][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float corr = exp2f(m_run[hr] - mx[hr]);
      m_run[hr] = mx[hr];
      l_run[hr] *= corr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * hr] *= corr;
        o[nt][2 * hr + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[nt][c] - m_run[c >> 1]);
        l_run[c >> 1] += p;
        s[nt][c] = p;
      }
    }

    if (a.dropout) {
      // As in the bf16 forward: keys 8nt + 4(t>>1) .. +3 form one Philox
      // group; the even lane of a pair draws it for row g, the odd one for
      // row g+8, and each reads the two words of each row it needs.
      const unsigned row = (unsigned)(row_g + ((t & 1) ? 8 : 0));
      const int even = lane & ~1, odd = lane | 1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint4 r = philox4x32_10(
            make_uint4((unsigned)(jb * kBlock + 8 * nt + 4 * (t >> 1)) >> 2, row, (unsigned)bh,
                       0u),
            make_uint2(seed, 0u));
        unsigned* slot = drop_w + (nt & 1) * kFwdDropWords;
        *reinterpret_cast<uint4*>(slot + fwd_drop_slot(lane)) = r;
        __syncwarp();
        const uint2 wg = *reinterpret_cast<const uint2*>(slot + fwd_drop_slot(even) + 2 * (t & 1));
        const uint2 wh = *reinterpret_cast<const uint2*>(slot + fwd_drop_slot(odd) + 2 * (t & 1));
        const unsigned w[4] = {wg.x, wg.y, wh.x, wh.y};
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] *= w[c] >= a.threshold ? a.keep_scale : 0.f;
      }
    }

    cp_async_wait<1>();  // V of tile jb
    __syncthreads();
    // O += P V: key tile kc's accumulators are the A fragment of its 8
    // keys (permuted); B = V rows 8kc + 2t, 8kc + 2t + 1 at column g.
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const SplitA pa = c_as_a(s[kc]);
      const float* vr = v_s + (8 * kc + 2 * t) * P + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_x3(o[nt], pa, vr[8 * nt], vr[P + 8 * nt]);
    }
    __syncthreads();  // every warp has read V
    if (jb < ib) stage_rows_f32<D, kF32Threads>(v_s, v, kBlock, (jb + 1) * kBlock, a.seq);
    cp_async_commit();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  float* out = static_cast<float*>(a.out) + base;
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(out + (size_t)row_g * D + 8 * nt + 2 * t) =
        make_float2(o[nt][0] * inv0, o[nt][1] * inv0);
    *reinterpret_cast<float2*>(out + (size_t)(row_g + 8) * D + 8 * nt + 2 * t) =
        make_float2(o[nt][2] * inv1, o[nt][3] * inv1);
  }
  if (t == 0) {
    a.lse[(size_t)bh * a.seq + row_g] = (m_run[0] + log2f(l_run[0])) * kLn2;
    a.lse[(size_t)bh * a.seq + row_g + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

// The backward's warps a key group: from D=64 two, each owning half of the
// columns of dK, dV, dE and dq (at D=64 one warp's accumulators take all 255
// registers and one block of 4 warps fits an SM: 1.04-1.10x the time on the
// card, 1.35x with the bias, PERF.md); otherwise one.
template <int D>
__host__ __device__ constexpr int bwd_f32_split() {
  return D >= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int bwd_f32_threads() {
  return kF32Threads * bwd_f32_split<D>();
}
// Buffers of the q-tile (Q, dO, lse, delta): two where they fit, one at
// D=128, where K, V, Q, dO and the band take 198 KB.
template <int D>
__host__ __device__ constexpr int bwd_f32_buffers() {
  return D > 64 ? 1 : 2;
}

// The column of key j (0..63) in the staged dS: even keys of each 8-key
// group first (j = 8a + b at 8a + b/2 + 4(b&1)), so that the dq product's
// A fragment, whose depth is permuted as its B operand K needs, is a plain
// row read.
__device__ __forceinline__ int ds_col(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// dS[i][j] of the staged tile; 0 for keys outside [0, 64) (the band's skew).
__device__ __forceinline__ float ds_at(const float* ds, int i, int j) {
  return (unsigned)j < (unsigned)kBlock ? ds[i * kDsF32Pitch + ds_col(j)] : 0.f;
}

// Floats of the backward's staged dS, which shares its bytes with the q.E
// staging (bias only) that it follows.
__host__ __device__ constexpr int qe_ds_floats(bool use_rel) {
  return use_rel && kF32Warps * 16 * kQePitch > kBlock * kDsF32Pitch ? kF32Warps * 16 * kQePitch
                                                                      : kBlock * kDsF32Pitch;
}

// Shared memory of the backward: K, V, the q-tile's buffers, the staged
// dS (and q.E), lse and delta, the dropout words and, with the bias, the band.
template <int D>
__host__ __device__ constexpr size_t backward_f32_base_smem(bool use_rel) {
  return sizeof(float) * ((size_t)(2 * kBlock + 2 * bwd_f32_buffers<D>() * kBlock +
                                   (use_rel ? kBand : 0)) * f32_pitch<D>() +
                          qe_ds_floats(use_rel) + 2 * bwd_f32_buffers<D>() * kBlock) +
         sizeof(unsigned) * kF32Warps * bwd_f32_split<D>() * kDropWords;
}
// The exchange of a split key group (S^T from one warp, dP^T from the
// other): 16 x 64 floats a warp, in C-fragment order.
constexpr size_t kExchangeBytes = sizeof(float) * kF32Warps * 2 * 16 * kBlock;
// Split key groups exchange their products where the buffer fits: everywhere
// but D=128 with the bias, whose two warps both form S^T and dP^T.
template <int D>
__host__ __device__ constexpr bool bwd_f32_exchange(bool use_rel) {
  return bwd_f32_split<D>() == 2 &&
         backward_f32_base_smem<D>(use_rel) + kExchangeBytes <= (size_t)kMaxSharedBytes;
}
template <int D>
size_t backward_f32_smem(bool use_rel) {
  return backward_f32_base_smem<D>(use_rel) + (bwd_f32_exchange<D>(use_rel) ? kExchangeBytes : 0);
}

// The barrier of key group kw's two warps (named barrier 1 + kw, 64 threads).
__device__ __forceinline__ void pair_sync(int kw) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + kw) : "memory");
}

// FlashAttention-2 order: a block owns a 64-key tile (16 keys a warp, or a
// key group of two warps from D=64, each owning half of the columns) and
// walks the q-tiles at or after the diagonal, recomputing P from lse. dK and
// dV stay in registers; dS goes to shared memory for dq = c (dS K + Bm
// E_band) (Bm the skewed dS), sent by 4-float atomics, and dE_band = c
// Bm^T Q, whose rows leave once, when no later q-tile reaches them.
template <int D>
__global__ void __launch_bounds__(bwd_f32_threads<D>())
    flash_backward_tf32_kernel(const Args a) {
  constexpr int kSplit = bwd_f32_split<D>(), kThreads = bwd_f32_threads<D>();
  constexpr int kBuf = bwd_f32_buffers<D>();
  constexpr int P = f32_pitch<D>(), KS = D / 8, DW = D / kSplit, NTW = DW / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* k_s = reinterpret_cast<float*>(f32_smem);  // [64][P] this block's keys
  float* v_s = k_s + kBlock * P;                      // [64][P]
  float* q_s = v_s + kBlock * P;                      // [kBuf][64][P]
  float* do_s = q_s + kBuf * kBlock * P;              // [kBuf][64][P]
  float* e_s = do_s + kBuf * kBlock * P;              // with the bias: [128][P]
  // The q.E staging [key group][16][kQePitch] (bias only), then the same
  // bytes as dS [64 queries][kDsF32Pitch] (keys permuted by ds_col).
  float* qe_s = e_s + (a.use_rel ? kBand * P : 0);
  float* ds_s = qe_s;
  float* lse_s = qe_s + qe_ds_floats(a.use_rel);                         // [kBuf][64]
  float* delta_s = lse_s + kBuf * kBlock;                                // [kBuf][64]
  unsigned* drop_s = reinterpret_cast<unsigned*>(delta_s + kBuf * kBlock);  // [warp][kDropWords]
  // [key group][warp of the group][8 n-tiles][lane] S^T or dP^T fragments
  float4* xch_s = reinterpret_cast<float4*>(drop_s + kF32Warps * kSplit * kDropWords);
  const bool exchange = bwd_f32_exchange<D>(a.use_rel);

  const int nb = a.seq / kBlock;
  const int jb = blockIdx.x;  // the longest columns start first
  const int bh = blockIdx.y, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // The warp's group of 16 keys (phase 2), queries (3a) and band rows (3b),
  // and its columns [cd, cd + DW) of dK, dV, dq and dE.
  const int kw = warp % kF32Warps, dh = warp / kF32Warps, cd = dh * DW;
  const int w16 = 16 * kw;
  const int W = a.window;
  const size_t base = (size_t)bh * a.seq * D;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;
  const float* e_head = a.use_rel ? static_cast<const float*>(a.e) + (size_t)h * W * D : nullptr;
  float* de_head = a.use_rel ? a.de + (size_t)h * W * D : nullptr;
  const float* lse = a.lse + (size_t)bh * a.seq;
  const float* delta = a.delta + (size_t)bh * a.seq;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;
  const float c2 = a.scale * kLog2e;
  float* qe_w = qe_s + kw * 16 * kQePitch;
  unsigned* drop_w = drop_s + warp * kDropWords;

  auto stage = [&](int ib, int buf) {
    stage_rows_f32<D, kThreads>(q_s + buf * kBlock * P, q, kBlock, ib * kBlock, a.seq);
    stage_rows_f32<D, kThreads>(do_s + buf * kBlock * P, dout, kBlock, ib * kBlock, a.seq);
    stage_floats<kThreads>(lse_s + buf * kBlock, lse + ib * kBlock, kBlock);
    stage_floats<kThreads>(delta_s + buf * kBlock, delta + ib * kBlock, kBlock);
  };
  // The band of q-tile ib: E rows W - 64 - 64 (ib - jb) + [0, 128).
  auto stage_band = [&](int ib) {
    stage_rows_f32<D, kThreads>(e_s, e_head, kBand, W - kBlock - (ib - jb) * kBlock, W);
  };
  stage_rows_f32<D, kThreads>(k_s, k, kBlock, jb * kBlock, a.seq);
  stage_rows_f32<D, kThreads>(v_s, v, kBlock, jb * kBlock, a.seq);
  stage(jb, 0);
  if (a.use_rel) stage_band(jb);
  cp_async_commit();

  float dk_acc[NTW][4] = {}, dv_acc[NTW][4] = {};  // this warp's 16 keys x DW columns
  // dE of this warp's 16 band rows of the lo half (rows m = w16 + (g, g+8)
  // of the band, E rows W - 64 - 64tt + m), carried to the next q-tile,
  // where the same E rows are band rows m + 64 of the warp's hi tile.
  float de_acc[NTW][4] = {};

  for (int ib = jb; ib < nb; ++ib) {
    const int tt = ib - jb, buf = kBuf == 2 ? (tt & 1) : 0;
    if (kBuf == 1 && tt > 0) {
      __syncthreads();  // no warp still reads q-tile ib - 1
      stage(ib, 0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // q-tile ib (and its band) is staged; q-tile ib - 1 is consumed
    if (kBuf == 2 && ib + 1 < nb) {
      stage(ib + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* qt = q_s + buf * kBlock * P;
    const float* dot = do_s + buf * kBlock * P;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;

    // 1. q.E of this key group's 16 queries against their 80 band rows, as
    //    in the forward (at D=128 the group's two warps take 5 of the 10
    //    8-row tiles each); phase 2 reads it transposed, so every group's
    //    is needed.
    if (a.use_rel) {
      const float* q_row = qt + (w16 + g) * P + t;
      if (kSplit == 1) {
        band_product_f32<D>(qe_w, q_row, e_s, 48 - w16, lane);
      } else if (dh == 0) {
        band_product_f32<D, 0, kBandSlice / 16>(qe_w, q_row, e_s, 48 - w16, lane);
      } else {
        band_product_f32<D, kBandSlice / 16, kBandSlice / 8>(qe_w, q_row, e_s, 48 - w16, lane);
      }
      __syncthreads();
    }

    // 2. This warp's keys j = w16 + (g, g+8) against the 64 queries i =
    //    8nt + 2t (+1): S^T = K Q^T (+ band), P^T, dP^T = V dO^T, dS^T.
    //    A split key group with the exchange forms S^T in its warp 0 and
    //    dP^T in its warp 1, and each hands its product to the other.
    float st[8][4] = {}, dpt[8][4] = {};
    const bool form_s = !exchange || dh == 0, form_dp = !exchange || dh == 1;
#pragma unroll 4  // in full, 1.19-1.26x the time at D=64, 1.56-1.60x at D=128 (PERF.md)
    for (int ks = 0; ks < KS; ++ks) {
      if (form_s) {
        const SplitA ka = load_a(k_s + (w16 + g) * P + 8 * ks + t, P);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* qr = qt + (8 * nt + g) * P + 8 * ks + t;
          mma_x3(st[nt], ka, qr[0], qr[4]);
        }
      }
      if (form_dp) {
        const SplitA va = load_a(v_s + (w16 + g) * P + 8 * ks + t, P);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* dr = dot + (8 * nt + g) * P + 8 * ks + t;
          mma_x3(dpt[nt], va, dr[0], dr[4]);
        }
      }
    }
    if (exchange) {
      float4* mine = xch_s + (2 * kw + dh) * 8 * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mine[32 * nt] = dh == 0 ? make_float4(st[nt][0], st[nt][1], st[nt][2], st[nt][3])
                                : make_float4(dpt[nt][0], dpt[nt][1], dpt[nt][2], dpt[nt][3]);
      }
      pair_sync(kw);
      const float4* theirs = xch_s + (2 * kw + (dh ^ 1)) * 8 * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 x = theirs[32 * nt];
        const float got[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (dh == 0) {
            dpt[nt][c] = got[c];
          } else {
            st[nt][c] = got[c];
          }
        }
      }
    }
    const bool diag = tt == 0;
    const int cl = g & 3, grp = g >> 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      unsigned words[4] = {0u, 0u, 0u, 0u};
      if (a.dropout) {
        // As in the bf16 backward: element c of this lane (key w16 + g +
        // 8(c>>1), query 8nt + 2t + (c&1)) is word g&3 of the Philox call
        // for its 4-key group and query; lane cl of the four that need the
        // same calls draws call cl, and each reads word cl of call c from
        // lane 4(4grp + c) + t through the warp's buffer.
        const uint4 r = philox4x32_10(
            make_uint4((unsigned)(jb * kBlock + w16 + 4 * grp + 8 * (cl >> 1)) >> 2,
                       (unsigned)(ib * kBlock + 8 * nt + 2 * t + (cl & 1)), (unsigned)bh, 0u),
            make_uint2(seed, 0u));
        *reinterpret_cast<uint4*>(drop_w + 4 * lane + 16 * grp) = r;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 4; ++c) words[c] = drop_w[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];
        __syncwarp();  // read before the next step overwrites the buffer
      }
      // lse and delta of this lane's two queries, one 8-byte load each.
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + 8 * nt + 2 * t);
      const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + 8 * nt + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = w16 + g + 8 * (c >> 1), i = 8 * nt + 2 * t + (c & 1);
        float x = st[nt][c];
        if (a.use_rel) x += qe_s[(i >> 4) * 16 * kQePitch + (i & 15) * (kQePitch - 1) + 15 + j];
        const float lse_i = (c & 1) ? lse2.y : lse2.x, delta_i = (c & 1) ? delta2.y : delta2.x;
        const float p = (diag && j > i) ? 0.f : exp2f(fmaf(x, c2, -lse_i * kLog2e));
        const float mult = a.dropout ? (words[c] >= a.threshold ? a.keep_scale : 0.f) : 1.f;
        dpt[nt][c] = p * (dpt[nt][c] * mult - delta_i);  // dS^T
        st[nt][c] = p * mult;                            // (P M)^T
      }
    }
    // dV += (P M)^T dO, dK += dS^T Q over this warp's columns: A from the
    // accumulators (depth = query, permuted), B = dO, Q rows 8kc + 2t, +1.
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const SplitA pa = c_as_a(st[kc]);
      const SplitA da = c_as_a(dpt[kc]);
      const float* dr = dot + (8 * kc + 2 * t) * P + cd + g;
      const float* qr = qt + (8 * kc + 2 * t) * P + cd + g;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        mma_x3(dv_acc[nt], pa, dr[8 * nt], dr[P + 8 * nt]);
        mma_x3(dk_acc[nt], da, qr[8 * nt], qr[P + 8 * nt]);
      }
    }
    if (a.use_rel) __syncthreads();  // every warp has read the q.E that dS overwrites
    // dS of this warp's keys (one warp of the group), [query][ds_col(key)].
    if (dh == 0) {
      const int col = w16 + ((g >> 1) | ((g & 1) << 2));  // ds_col(w16 + g)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 8 * nt + 2 * t + (c & 1);
          ds_s[i * kDsF32Pitch + col + 8 * (c >> 1)] = dpt[nt][c];
        }
      }
    }
    __syncthreads();

    // 3a. dq of this warp's queries i = w16 + (g, g+8), its columns:
    //     c (dS K + Bm E_band), Bm[i, m] = dS[i, m - 63 + i] over the warp's
    //     80 band rows m = 48 - w16 + c', i.e. key j = c' - 15 + (i - w16).
    {
      float dq_acc[NTW][4] = {};
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        const SplitA da = load_a(ds_s + (w16 + g) * kDsF32Pitch + 8 * kc + t, kDsF32Pitch);
        const float* kr = k_s + (8 * kc + 2 * t) * P + cd + g;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_x3(dq_acc[nt], da, kr[8 * nt], kr[P + 8 * nt]);
      }
      if (a.use_rel) {
#pragma unroll 2
        for (int kc = 0; kc < kBandSlice / 8; ++kc) {
          // Depth (band rows) permuted: column t is band row 48 - w16 + 8kc
          // + 2t, column t+4 the next.
          const int i = w16 + g, j = 8 * kc + 2 * t - 15 + g;
          const SplitA ba = split_a(ds_at(ds_s, i, j), ds_at(ds_s, i + 8, j + 8),
                                    ds_at(ds_s, i, j + 1), ds_at(ds_s, i + 8, j + 9));
          const float* er = e_s + (48 - w16 + 8 * kc + 2 * t) * P + cd + g;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_x3(dq_acc[nt], ba, er[8 * nt], er[P + 8 * nt]);
        }
      }
      atomic_add_tile<NTW>(a.dq + base + (size_t)(ib * kBlock + w16) * D + cd, dq_acc, a.scale,
                           lane, D);
    }

    // 3b. dE_band[m] += c sum_i Bm[i, m] q_i over 16-row tiles of band rows,
    //     this warp's columns: its hi tile (m = 64 + w16 + .., the carried
    //     rows, complete after this q-tile) and lo tile (m = w16 + ..,
    //     carried on).
    if (a.use_rel) {
      __syncthreads();  // every warp has read the band: stage the next one
      if (ib + 1 < nb) {
        stage_band(ib + 1);
        cp_async_commit();
      }
#pragma unroll
      for (int half = 1; half >= 0; --half) {
        const int mt = kw + 4 * half, m0 = 16 * mt;
        // Queries that reach this tile: i in [48 - m0, 126 - m0], in 8-query steps.
        const int kc0 = max(0, 6 - 2 * mt), kc1 = min(7, (126 - m0) >> 3);
        for (int kc = kc0; kc <= kc1; ++kc) {
          // A = Bm^T[m, i] = dS[i][m - 63 + i]: rows m = m0 + (g, g+8),
          // depth (queries) permuted: column t is query 8kc + 2t, t+4 the next.
          const int i = 8 * kc + 2 * t, j = m0 + g - 63 + i;
          const SplitA ba = split_a(ds_at(ds_s, i, j), ds_at(ds_s, i, j + 8),
                                    ds_at(ds_s, i + 1, j + 1), ds_at(ds_s, i + 1, j + 9));
          const float* qr = qt + (8 * kc + 2 * t) * P + cd + g;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_x3(de_acc[nt], ba, qr[8 * nt], qr[P + 8 * nt]);
        }
        if (half) {
          // No later q-tile reaches the hi rows (E rows W - 64tt + w16 + ..;
          // none exist for the diagonal tile, whose hi part is masked).
          if (tt > 0) {
            atomic_add_tile<NTW>(de_head + (size_t)(W - tt * kBlock + w16) * D + cd, de_acc,
                                 a.scale, lane, D);
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) de_acc[nt][c] = 0.f;
          }
        }
      }
    }
  }
  if (a.use_rel) {
    const int t_last = nb - 1 - jb;
    atomic_add_tile<NTW>(de_head + (size_t)(W - kBlock - t_last * kBlock + w16) * D + cd, de_acc,
                         a.scale, lane, D);
  }

  const size_t out_row = (size_t)(jb * kBlock + w16 + g) * D + cd + 2 * t;
  float* dk_out = static_cast<float*>(a.dk) + base + out_row;
  float* dv_out = static_cast<float*>(a.dv) + base + out_row;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    *reinterpret_cast<float2*>(dk_out + 8 * nt) =
        make_float2(a.scale * dk_acc[nt][0], a.scale * dk_acc[nt][1]);
    *reinterpret_cast<float2*>(dk_out + 8 * D + 8 * nt) =
        make_float2(a.scale * dk_acc[nt][2], a.scale * dk_acc[nt][3]);
    *reinterpret_cast<float2*>(dv_out + 8 * nt) = make_float2(dv_acc[nt][0], dv_acc[nt][1]);
    *reinterpret_cast<float2*>(dv_out + 8 * D + 8 * nt) = make_float2(dv_acc[nt][2], dv_acc[nt][3]);
  }
}
