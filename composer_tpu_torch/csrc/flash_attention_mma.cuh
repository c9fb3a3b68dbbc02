// flash_attention_mma.cuh: the bf16 tensor-core flash attention kernels,
// forward (flash_forward_mma_kernel, replacing pallas_attention.py
// _flash_kernel) and backward (flash_backward_mma_kernel, replacing
// _flash_bwd_kernel), for head_dim D = 16, 32, 64 and 128. flash_attention.cu's
// header states the contract and the design; this file is included by it,
// inside its namespace, after Args, kBlock, kBand, kNegInf and philox4x32_10.
//
// A block is 4 warps over one 64-row tile (the backward at D=128: 8, two
// warps a key group, bwd_split). Fragment names follow the PTX
// m16n8k16 layouts: lane = 4 g + t; an A fragment holds rows g and g+8,
// columns 2t, 2t+1 (and +8); a C fragment rows g and g+8, columns 2t, 2t+1
// of an 8-column tile.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBandSlice = 80;        // band rows one warp's 16 rows reach (79, rounded up)
// Floats per row of a warp's staged q.E: odd, so that the backward's
// transposed skew read is free of bank conflicts.
constexpr int kQePitch = 85;
constexpr int kDsPitch = kBlock + 8;  // bf16 per row of the staged dS^T
// Dropout: a warp's Philox words, 4 a lane, through shared memory to the
// lanes that need them, in two buffers (one __syncwarp a step). Padded so
// that the reads are conflict-free (fwd_drop_slot; backward, lanes 16-31
// 16 words on).
constexpr int kFwdDropWords = 4 * 32 + 12;
constexpr int kDropWords = 4 * 32 + 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src must still be mapped).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 in one register, lo in the low half (the lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ldmatrix lane addresses into a row-major bf16 tile of pitch P.
// A fragment of rows [r0, r0+16), columns [c0, c0+16).
__device__ __forceinline__ int a_off(int lane, int pitch, int r0, int c0) {
  return (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8;
}
// B fragments (b0, b1) of the n-tiles n0 and n0+8, depth [k0, k0+16), from a
// tile stored [n][k] (non-transposed load).
__device__ __forceinline__ int b_off(int lane, int pitch, int n0, int k0) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8;
}
// The same from a tile stored [k][n] (transposed load).
__device__ __forceinline__ int bt_off(int lane, int pitch, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
}
// A fragment of rows [m0, m0+16), columns [k0, k0+16) from a tile stored
// [k][m] (transposed load).
__device__ __forceinline__ int at_off(int lane, int pitch, int k0, int m0) {
  return (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8;
}

// Rows [first, first+rows) of a [limit, D] bf16 matrix into shared memory at
// pitch D+8 (16-byte rows land on distinct banks for ldmatrix), zeros for
// rows outside [0, limit), by the block's Threads threads. Issued with
// cp.async, not committed.
template <int D, int Threads = kMmaThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int first,
                                           int limit) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += Threads) {
    const int r = idx / kChunks, c = idx % kChunks, row = first + r;
    const bool valid = row >= 0 && row < limit;
    cp_async16(dst + r * (D + 8) + c * 8, src + (size_t)(valid ? row : 0) * D + c * 8, valid);
  }
}

template <int Threads = kMmaThreads>
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int count) {
  for (int idx = threadIdx.x; idx < count / 4; idx += Threads) {
    cp_async16(dst + 4 * idx, src + 4 * idx, true);
  }
}

// One 16-byte atomic where the toolkit declares it for sm_90 (built and run
// with CUDA 12.9), four otherwise.
__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 9)
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// q.E of one warp's 16 rows (A fragments qa) against the 80 band rows
// [e_row0, e_row0+80) of the staged band et, into the warp's staging rows
// qe (16 x kBandSlice floats at pitch kQePitch, unskewed); only the 16-row
// groups [np0, np1) of the 5 (the D=128 backward splits them over two warps).
template <int D>
__device__ __forceinline__ void band_product(float* qe, const unsigned (&qa)[D / 16][4],
                                             const bf16* et, int e_row0, int lane, int np0 = 0,
                                             int np1 = kBandSlice / 16) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int np = 0; np < kBandSlice / 16; ++np) {
    if (np < np0 || np >= np1) continue;
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned b[4];
      ldsm_x4(b, et + b_off(lane, D + 8, e_row0 + 16 * np, 16 * ks));
      mma16816(acc[0], qa[ks], b[0], b[1]);
      mma16816(acc[1], qa[ks], b[2], b[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 16 * np + 8 * half + 2 * t;
      qe[g * kQePitch + col] = acc[half][0];
      qe[g * kQePitch + col + 1] = acc[half][1];
      qe[(g + 8) * kQePitch + col] = acc[half][2];
      qe[(g + 8) * kQePitch + col + 1] = acc[half][3];
    }
  }
}

// First word of a lane's 4 in the forward's dropout buffer: lanes 8-15 and
// 24-31 4 words on, lanes 16-31 8 more.
__device__ __forceinline__ int fwd_drop_slot(int lane) {
  return 4 * lane + 4 * ((lane >> 3) & 1) + 8 * (lane >> 4);
}

// Shared memory of the forward; the band's buffers only with the bias, so
// that more blocks fit an SM without it.
template <int D>
size_t forward_mma_smem(bool use_rel) {
  return sizeof(bf16) * (size_t)(4 * kBlock + (use_rel ? 2 * kBand : 0)) * (D + 8) +
         sizeof(unsigned) * kMmaWarps * 2 * kFwdDropWords +
         (use_rel ? sizeof(float) * (size_t)kMmaWarps * 16 * kQePitch : 0);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_forward_mma_kernel(const Args a) {
  constexpr int P = D + 8, KS = D / 16, NT = D / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // [2][64][P]
  bf16* v_s = k_s + 2 * kBlock * P;               // [2][64][P]
  // [warp][2][kFwdDropWords] dropout words
  unsigned* drop_s = reinterpret_cast<unsigned*>(v_s + 2 * kBlock * P);
  // With the bias only: the band of the k-tile [2][128][P] and the staged q.E.
  bf16* e_s = reinterpret_cast<bf16*>(drop_s + kMmaWarps * 2 * kFwdDropWords);
  float* qe_s = reinterpret_cast<float*>(e_s + 2 * kBand * P);  // [warp][16][kQePitch]

  const int nb = a.seq / kBlock;
  const int ib = nb - 1 - (int)blockIdx.x;  // the longest rows start first
  const int bh = blockIdx.y, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                   // the warp's first row in the tile
  const int row_g = ib * kBlock + r0 + g;     // this lane's query rows: row_g, row_g + 8
  const size_t base = (size_t)bh * a.seq * D;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* e_head =
      a.use_rel ? static_cast<const bf16*>(a.e) + (size_t)h * a.window * D : nullptr;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;
  const float c2 = a.scale * kLog2e;  // scores in the exp2 domain
  float* qe_w = qe_s + warp * 16 * kQePitch;
  unsigned* drop_w = drop_s + warp * 2 * kFwdDropWords;

  auto stage = [&](int jb, int buf) {
    stage_rows<D>(k_s + buf * kBlock * P, k, kBlock, jb * kBlock, a.seq);
    stage_rows<D>(v_s + buf * kBlock * P, v, kBlock, jb * kBlock, a.seq);
    if (a.use_rel) {
      stage_rows<D>(e_s + buf * kBand * P, e_head, kBand,
                    a.window - kBlock - (ib - jb) * kBlock, a.window);
    }
    cp_async_commit();
  };
  stage(0, 0);

  unsigned qa[KS][4];  // this warp's 16 query rows as A fragments, for the whole walk
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* rg = q + (size_t)row_g * D + 16 * ks + 2 * t;
    qa[ks][0] = *reinterpret_cast<const unsigned*>(rg);
    qa[ks][1] = *reinterpret_cast<const unsigned*>(rg + 8 * D);
    qa[ks][2] = *reinterpret_cast<const unsigned*>(rg + 8);
    qa[ks][3] = *reinterpret_cast<const unsigned*>(rg + 8 * D + 8);
  }

  float o[NT][4] = {};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // rows g, g+8; l per lane

  for (int jb = 0; jb <= ib; ++jb) {
    const int buf = jb & 1;
    if (jb < ib) {
      stage(jb + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + buf * kBlock * P;
    const bf16* vt = v_s + buf * kBlock * P;
    const bf16* et = e_s + buf * kBand * P;

    float s[8][4] = {};  // 16 rows x 64 keys
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, kt + b_off(lane, P, 16 * np, 16 * ks));
        mma16816(s[2 * np], qa[ks], b[0], b[1]);
        mma16816(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    if (a.use_rel) {
      // Row r of the warp (tile row r0 + r) and key j need band row
      // 63 - (r0 + r) + j = (48 - r0) + (15 - r + j): one 16 x 80 product,
      // read back skewed.
      band_product<D>(qe_w, qa, et, 48 - r0, lane);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = g + 8 * (c >> 1), j = 8 * nt + 2 * t + (c & 1);
          s[nt][c] += qe_w[r * kQePitch + 15 - r + j];
        }
      }
      __syncwarp();  // read before the next tile overwrites it
    }

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
      // Keys 8nt + 4(t>>1) .. +3 form one Philox group. Lanes t and t^1
      // share it: the even lane draws it for row g, the odd one for row
      // g+8, and each reads the two words of each row it needs (words
      // 2(t&1), +1) from the pair's slots.
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

    // O += P V: the S accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of keys [16kc, 16kc+16).
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, vt + bt_off(lane, P, 16 * kc, 16 * np));
        mma16816(o[2 * np], pa, b[0], b[1]);
        mma16816(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the tile is consumed before the next stage overwrites it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  bf16* out = static_cast<bf16*>(a.out) + base;
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<unsigned*>(out + (size_t)row_g * D + 8 * nt + 2 * t) =
        pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
    *reinterpret_cast<unsigned*>(out + (size_t)(row_g + 8) * D + 8 * nt + 2 * t) =
        pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
  }
  if (t == 0) {
    a.lse[(size_t)bh * a.seq + row_g] = (m_run[0] + log2f(l_run[0])) * kLn2;
    a.lse[(size_t)bh * a.seq + row_g + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

// Two bf16 of the staged dS^T (pitch kDsPitch) as one A-fragment register:
// (key j, query i) in the low half and (key j + dj, query i + di) in the
// high half; keys outside [0, 64) give 0.
__device__ __forceinline__ unsigned ds_pair(const bf16* ds, int j, int i, int dj, int di) {
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(ds);
  const unsigned lo = (j >= 0 && j < kBlock) ? raw[j * kDsPitch + i] : 0u;
  const unsigned hi = (j + dj >= 0 && j + dj < kBlock) ? raw[(j + dj) * kDsPitch + i + di] : 0u;
  return lo | (hi << 16);
}

// The backward's warps a key group: at D=128 two, each owning half of the
// columns of dK, dV, dE and dq (D=64's register budget); otherwise one.
template <int D>
__host__ __device__ constexpr int bwd_split() {
  return D > 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int bwd_threads() {
  return kMmaThreads * bwd_split<D>();
}

template <int D>
size_t backward_mma_smem(bool use_rel) {
  return sizeof(bf16) * ((size_t)(6 * kBlock + (use_rel ? kBand : 0)) * (D + 8) +
                         kBlock * kDsPitch) +
         sizeof(float) * ((size_t)4 * kBlock + kMmaWarps * bwd_split<D>() * 2 * kDropWords +
                          (use_rel ? kMmaWarps * 16 * kQePitch : 0));
}

// Adds c times a 16 x (8 NTile) C-fragment tile (rows g and g+8 of this lane)
// to global float32 sums at dst, rows pitch floats apart: lanes t and t^1
// swap halves so that each issues one 4-float atomic per 8 columns.
template <int NTile>
__device__ __forceinline__ void atomic_add_tile(float* dst, const float (&acc)[NTile][4], float c,
                                                int lane, int pitch) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  float* row = dst + (size_t)(odd ? g + 8 : g) * pitch + 2 * (t & ~1);
#pragma unroll
  for (int nt = 0; nt < NTile; ++nt) {
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][0] : acc[nt][2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][1] : acc[nt][3], 1);
    const float4 v = odd ? make_float4(c * r0, c * r1, c * acc[nt][2], c * acc[nt][3])
                         : make_float4(c * acc[nt][0], c * acc[nt][1], c * r0, c * r1);
    atomic_add4(row + 8 * nt, v);
  }
}

// At head_dim 16, three blocks an SM (registers capped at 170); from 32 on the
// accumulators take what a thread can have. At D=128 (bwd_split) the two warps
// of a key group both form its S^T and dS^T over the full depth (the price of
// the split: QK^T and dO V^T twice), split the band's q.E between them, and
// each keeps and writes only its half of the columns of dK, dV, dq and dE.
template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), D == 16 ? 3 : 1)
    flash_backward_mma_kernel(const Args a) {
  constexpr int kSplit = bwd_split<D>(), kThreads = bwd_threads<D>();
  constexpr int P = D + 8, KS = D / 16, DW = D / kSplit, NTW = DW / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // [64][P] this block's keys
  bf16* v_s = k_s + kBlock * P;                    // [64][P]
  bf16* q_s = v_s + kBlock * P;                    // [2][64][P]
  bf16* do_s = q_s + 2 * kBlock * P;               // [2][64][P]
  bf16* ds_s = do_s + 2 * kBlock * P;              // [64 keys][kDsPitch] dS^T
  float* lse_s = reinterpret_cast<float*>(ds_s + kBlock * kDsPitch);  // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                                 // [2][64]
  // [warp][2][kDropWords]
  unsigned* drop_s = reinterpret_cast<unsigned*>(delta_s + 2 * kBlock);
  // With the bias only: the band of the current q-tile and the staged q.E.
  bf16* e_s = reinterpret_cast<bf16*>(drop_s + kMmaWarps * kSplit * 2 * kDropWords);  // [128][P]
  float* qe_s = reinterpret_cast<float*>(e_s + kBand * P);  // [key group][16][kQePitch]

  const int nb = a.seq / kBlock;
  const int jb = blockIdx.x;  // the longest columns start first
  const int bh = blockIdx.y, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // The warp's group of 16 keys (phase 2), queries (3a) and band rows (3b),
  // and its columns [cd, cd + DW) of dK, dV, dq and dE.
  const int kw = warp % kMmaWarps, dh = warp / kMmaWarps, cd = dh * DW;
  const int w16 = 16 * kw;
  const int W = a.window;
  const size_t base = (size_t)bh * a.seq * D;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;
  const bf16* e_head = a.use_rel ? static_cast<const bf16*>(a.e) + (size_t)h * W * D : nullptr;
  float* de_head = a.use_rel ? a.de + (size_t)h * W * D : nullptr;
  const float* lse = a.lse + (size_t)bh * a.seq;
  const float* delta = a.delta + (size_t)bh * a.seq;
  const unsigned seed = a.dropout ? (unsigned)*a.seed : 0u;
  const float c2 = a.scale * kLog2e;
  float* qe_w = qe_s + kw * 16 * kQePitch;
  unsigned* drop_w = drop_s + warp * 2 * kDropWords;

  auto stage = [&](int ib, int buf) {
    stage_rows<D, kThreads>(q_s + buf * kBlock * P, q, kBlock, ib * kBlock, a.seq);
    stage_rows<D, kThreads>(do_s + buf * kBlock * P, dout, kBlock, ib * kBlock, a.seq);
    stage_floats<kThreads>(lse_s + buf * kBlock, lse + ib * kBlock, kBlock);
    stage_floats<kThreads>(delta_s + buf * kBlock, delta + ib * kBlock, kBlock);
  };
  // The band of q-tile ib: E rows W - 64 - 64 (ib - jb) + [0, 128).
  auto stage_band = [&](int ib) {
    stage_rows<D, kThreads>(e_s, e_head, kBand, W - kBlock - (ib - jb) * kBlock, W);
  };
  stage_rows<D, kThreads>(k_s, k, kBlock, jb * kBlock, a.seq);
  stage_rows<D, kThreads>(v_s, v, kBlock, jb * kBlock, a.seq);
  stage(jb, 0);
  if (a.use_rel) stage_band(jb);
  cp_async_commit();

  float dk_acc[NTW][4] = {}, dv_acc[NTW][4] = {};  // this warp's 16 keys x DW columns
  // dE of this warp's 16 band rows of the lo half (rows m = w16 + (g, g+8)
  // of the band, E rows W - 64 - 64tt + m), carried to the next q-tile,
  // where the same E rows are band rows m + 64 of the warp's hi tile.
  float de_acc[NTW][4] = {};

  for (int ib = jb; ib < nb; ++ib) {
    const int tt = ib - jb, buf = tt & 1;
    cp_async_wait<0>();
    __syncthreads();  // q-tile ib is staged, and no warp still reads q-tile ib - 1
    if (ib + 1 < nb) {
      stage(ib + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* qt = q_s + buf * kBlock * P;
    const bf16* dot = do_s + buf * kBlock * P;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;

    // 1. q.E of this key group's 16 queries against their 80 band rows, as
    //    in the forward (at D=128 the group's two warps take 3 and 2 of the
    //    5 16-row groups); phase 2 reads it transposed, so every group's is
    //    needed.
    if (a.use_rel) {
      unsigned qa[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qa[ks], qt + a_off(lane, P, w16, 16 * ks));
      band_product<D>(qe_w, qa, e_s, 48 - w16, lane, 3 * dh,
                      (kSplit == 1 || dh) ? kBandSlice / 16 : 3);
      __syncthreads();
    }

    // 2. This warp's keys j = w16 + (g, g+8) against the 64 queries i =
    //    8nt + 2t (+1): S^T = K Q^T (+ band), P^T, dP^T = V dO^T, dS^T.
    float st[8][4] = {}, dpt[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, k_s + a_off(lane, P, w16, 16 * ks));
      ldsm_x4(va, v_s + a_off(lane, P, w16, 16 * ks));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, qt + b_off(lane, P, 16 * np, 16 * ks));
        mma16816(st[2 * np], ka, b[0], b[1]);
        mma16816(st[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, dot + b_off(lane, P, 16 * np, 16 * ks));
        mma16816(dpt[2 * np], va, b[0], b[1]);
        mma16816(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }
    const bool diag = tt == 0;
    const int cl = g & 3, grp = g >> 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      unsigned words[4] = {0u, 0u, 0u, 0u};
      if (a.dropout) {
        // Element c of this lane (key w16 + g + 8(c>>1), query 8nt + 2t +
        // (c&1)) is word g&3 of the Philox call for its 4-key group and
        // query. The four lanes of equal grp and t that differ in g&3 need
        // the same four calls: lane cl draws call cl, and each lane reads
        // word cl of call c from lane 4(4grp + c) + t through the warp's
        // buffer (two of them, so one __syncwarp a step suffices).
        const uint4 r = philox4x32_10(
            make_uint4((unsigned)(jb * kBlock + w16 + 4 * grp + 8 * (cl >> 1)) >> 2,
                       (unsigned)(ib * kBlock + 8 * nt + 2 * t + (cl & 1)), (unsigned)bh, 0u),
            make_uint2(seed, 0u));
        unsigned* slot = drop_w + (nt & 1) * kDropWords;
        *reinterpret_cast<uint4*>(slot + 4 * lane + 16 * grp) = r;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 4; ++c) words[c] = slot[4 * (4 * (4 * grp + c) + t) + 16 * grp + cl];
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
    // accumulators, B = dO, Q (depth = query).
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      const unsigned da[4] = {pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
                              pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
                              pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                              pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, dot + bt_off(lane, P, 16 * kc, cd + 16 * np));
        mma16816(dv_acc[2 * np], pa, b[0], b[1]);
        mma16816(dv_acc[2 * np + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, qt + bt_off(lane, P, 16 * kc, cd + 16 * np));
        mma16816(dk_acc[2 * np], da, b[0], b[1]);
        mma16816(dk_acc[2 * np + 1], da, b[2], b[3]);
      }
      // Row j of dS^T in shared memory for phase 3 (one warp of the group).
      if (dh == 0) {
        const int i = 16 * kc + 2 * t;
        *reinterpret_cast<unsigned*>(ds_s + (w16 + g) * kDsPitch + i) = da[0];
        *reinterpret_cast<unsigned*>(ds_s + (w16 + g + 8) * kDsPitch + i) = da[1];
        *reinterpret_cast<unsigned*>(ds_s + (w16 + g) * kDsPitch + i + 8) = da[2];
        *reinterpret_cast<unsigned*>(ds_s + (w16 + g + 8) * kDsPitch + i + 8) = da[3];
      }
    }
    __syncthreads();

    // 3a. dq of this warp's queries i = w16 + (g, g+8), its columns:
    //     c (dS K + Bm E_band), Bm[i, m] = dS[i, m - 63 + i] over the warp's
    //     80 band rows m = 48 - w16 + c, i.e. key j = c - 15 + (i - w16).
    {
      float dq_acc[NTW][4] = {};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        unsigned da[4];
        ldsm_x4_t(da, ds_s + at_off(lane, kDsPitch, 16 * kc, w16));
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          unsigned b[4];
          ldsm_x4_t(b, k_s + bt_off(lane, P, 16 * kc, cd + 16 * np));
          mma16816(dq_acc[2 * np], da, b[0], b[1]);
          mma16816(dq_acc[2 * np + 1], da, b[2], b[3]);
        }
      }
      if (a.use_rel) {
#pragma unroll
        for (int kc = 0; kc < kBandSlice / 16; ++kc) {
          const int j = 16 * kc + 2 * t - 15 + g, i = w16 + g;
          const unsigned ba[4] = {ds_pair(ds_s, j, i, 1, 0), ds_pair(ds_s, j + 8, i + 8, 1, 0),
                                  ds_pair(ds_s, j + 8, i, 1, 0),
                                  ds_pair(ds_s, j + 16, i + 8, 1, 0)};
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            unsigned b[4];
            ldsm_x4_t(b, e_s + bt_off(lane, P, 48 - w16 + 16 * kc, cd + 16 * np));
            mma16816(dq_acc[2 * np], ba, b[0], b[1]);
            mma16816(dq_acc[2 * np + 1], ba, b[2], b[3]);
          }
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
        // Queries that reach this tile: i in [48 - m0, 126 - m0].
        const int kc0 = max(0, 3 - mt), kc1 = min(3, 7 - mt);
        for (int kc = kc0; kc <= kc1; ++kc) {
          // A = Bm^T[m, i] = dS^T[m - 63 + i][i]: rows m = m0 + (g, g+8),
          // columns i = 16kc + 2t (+1, +8).
          const int i = 16 * kc + 2 * t, j = m0 + g - 63 + i;
          const unsigned ba[4] = {ds_pair(ds_s, j, i, 1, 1), ds_pair(ds_s, j + 8, i, 1, 1),
                                  ds_pair(ds_s, j + 8, i + 8, 1, 1),
                                  ds_pair(ds_s, j + 16, i + 8, 1, 1)};
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            unsigned b[4];
            ldsm_x4_t(b, qt + bt_off(lane, P, 16 * kc, cd + 16 * np));
            mma16816(de_acc[2 * np], ba, b[0], b[1]);
            mma16816(de_acc[2 * np + 1], ba, b[2], b[3]);
          }
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
  bf16* dk_out = static_cast<bf16*>(a.dk) + base + out_row;
  bf16* dv_out = static_cast<bf16*>(a.dv) + base + out_row;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    *reinterpret_cast<unsigned*>(dk_out + 8 * nt) =
        pack_bf16(a.scale * dk_acc[nt][0], a.scale * dk_acc[nt][1]);
    *reinterpret_cast<unsigned*>(dk_out + 8 * D + 8 * nt) =
        pack_bf16(a.scale * dk_acc[nt][2], a.scale * dk_acc[nt][3]);
    *reinterpret_cast<unsigned*>(dv_out + 8 * nt) = pack_bf16(dv_acc[nt][0], dv_acc[nt][1]);
    *reinterpret_cast<unsigned*>(dv_out + 8 * D + 8 * nt) = pack_bf16(dv_acc[nt][2], dv_acc[nt][3]);
  }
}
