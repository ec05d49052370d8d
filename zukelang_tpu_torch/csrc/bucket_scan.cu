// K5 and K8: segmented running mixed adds over sorted, sign-applied affine
// points with the accumulator and the collision flag in registers (the
// Pallas grid's sequential t axis): K5 one thread per chunk lane, K8 g
// lanes a chunk.  Both share jac_madd<G>'s formula (curve.cuh).
//
// K5 replaces bucket_scan_rows (zukelang_tpu/ops/pallas_kernels.py:1296;
// kernel _seg_scan_kernel2 :1192, call _seg_scan2_call :1253).  The Pallas
// kernel takes its points already gathered and relaid out as (K, 2 rows,
// M) and writes every step's accumulator; on the card that costs two
// copies of the gathered rows and a (K, rows, M) output of which the MSM
// reads only the chunk ends and one column per bucket.  Here the kernel
// gathers: lane (chunk) m of block row b takes, at step t, the row
// idx[b, m K + t] of the table `rows` (Nrows, 2 rows) of affine [X; Y]
// points ((0, 0) = infinity), and the accumulator restarts at t = 0 and
// where the sorted segment id changes (seg null: one segment per chunk).
// A block first stages its lanes' K indices and segment ids in shared
// memory with coalesced loads (rows padded to K + 1 words, so the lanes'
// reads hit distinct banks); each lane then loads its 96 B (G1) row per
// step with 16-byte loads.  It writes each chunk's final accumulator
// (tails, (rows, lanes)) and, with nb, each bucket's in-chunk tail: at
// the step where the segment ends (the digit changes, or the block row
// ends), the accumulator goes to column b nb + seg of the (rows, B nb)
// bucket outputs, which the wrapper zero-fills.
// Bound: the 11 Fq products of each continuing step with both operands
// finite.  The madd is inlined; its field products are the coordinate
// field's out-of-line calls (inlined they were no faster).  Blocks of 128,
// 4 an SM, hold the Groth16 prove's 163,840 G1 lanes at 2^16 in whole
// waves.  G2 runs behind the same entry point on thread pairs, one Fq
// component a thread (bucket_scan_g2.cu): one thread a lane spilled.
//
// K8 replaces bucket_scan_pallas (pallas_kernels.py:807; kernel
// _seg_scan_kernel :709, call _seg_scan_call :778): the inclusive
// segmented prefix sum of each chunk of K affine points in the flat
// (rows, n) layout, every step's (X, Y, Z) written, one collision flag a
// chunk.  Element t of chunk m is column m K + t, and seg is compared
// with its predecessor in the kernel, so there is neither the Pallas
// (K, rows, M) relayout nor a segp input.
// Bound: on the card, the chain of dependent mixed adds a chunk and the
// instruction throughput of their products.  The first form, one thread
// a chunk, ran a chain of K - 1 = 31 madds on 8,192 threads at 2^18: 64
// blocks of 128 for 132 SMs, one warp a busy scheduler, 0.96 ms against
// 0.05 of operations.
// Design: g lanes a chunk (g a power of two dividing K, at most 32, from
// `kernels.bscan_group`), lane l taking the L = K / g points l L ..
// l L + L - 1, as K7 does with full adds:
//   1. reduce: the lane sums its points with madds, restarting where seg
//      changes, the doubling case resolved (jac_double), so this phase
//      raises no flag; f notes a restart in the lane (L - 1 madds);
//   2. scan: a Hillis-Steele scan of the g lane totals with shuffles and
//      full adds (jac_add: P == Q, P == -Q, infinity), the segmented
//      operator (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2)
//      (log2 g adds); lane l - 1's prefix is lane l's carry;
//   3. rescan: the lane walks its points again from the carry (until its
//      first restart), storing every step, the madd's garbage and flag
//      kept as the sequential scan keeps them (L madds).
// Before each step of phase 3 the accumulator is the point the
// sequential scan holds there, so a chunk is flagged (the OR of its
// lanes) exactly where the sequential scan flags it; at g = 1 phases 1
// and 2 are skipped and the words are the sequential scan's.  The chain
// is 2L - 1 madds + log2 g adds (g = 4, K = 32: 15 + 2 against 31); the
// work 2K - g madds + g log2 g adds a chunk, which bounds a wide launch,
// so the width is a cost model of both (`bscan_group`).  The shuffles
// stand outside the adds, where every lane of the warp (idle groups on
// zeros) takes part.
// The coordinate products are out of line but take and return their
// operands by value (`G1ByValue`, `G2ByValue`), so no temporary of the
// formulas needs an address: with the fields' by-pointer calls the G1
// kernel kept a 1,968-byte stack frame a thread, which on the wide
// launches outgrew L1 (2^18, g = 4: 0.87 ms); by value it keeps a
// 432-byte frame, touched only by phase 2's adds and a doubling, at 2
// blocks of 128 an SM (G2 3 blocks of 64 or more, 255 registers).
// Loads and stores: read in place, a warp's lanes are L columns apart,
// so at L = 8 each 4-byte access takes its own 32-byte sector, and the
// kernel's loads and stores alone (all-restart segments) take time in
// step with L, not with the bytes.  So a G1 block copies rows X, Y and
// seg of its columns into shared memory with coalesced loads (padded one
// word in 32, so the lanes' reads hit distinct banks), writes each
// step's X and Y back over the input it has read, and copies them out
// coalesced, Z going straight out: where two blocks' copies fit an SM
// (K = 32: g >= 4, 105 KB at g = 4).  At 2^18 G1, g = 4, that cut the
// loads and stores alone from 0.167 to 0.073 ms and the kernel by about
// 5 % (the rest overlaps the products); G2 reads in place, as its
// copies, taking the L1 that holds its spills, measured slower (PERF.md
// §6).
#include "curve.cuh"
#include "scan_rows.cuh"

namespace zk {

// K8's coordinate fields: the products out of line, operands and result
// by value (see the note above).
static __device__ __noinline__ FqE fq_mul_val(const FqE a, const FqE b) {
  FqE r;
  fp_mul<Fq>(r.v, a.v, b.v);
  return r;
}

static __device__ __noinline__ Fq2E fq2_mul_val(const Fq2E a, const Fq2E b) {
  Fq2E r;
  fq2_mul(r, a, b);
  return r;
}

struct G1ByValue : G1Field {
  __device__ static __forceinline__ void mul(E& r, const E& a, const E& b) {
    r = fq_mul_val(a, b);
  }
};

struct G2ByValue : G2Field {
  __device__ static __forceinline__ void mul(E& r, const E& a, const E& b) {
    r = fq2_mul_val(a, b);
  }
};

// The affine point of one table row: G1 [X (12); Y (12)], G2 [X.c0; X.c1;
// Y.c0; Y.c1] (12 words each), read with 16-byte loads.
template <class G>
__device__ __forceinline__ void load_row(typename G::E& x, typename G::E& y,
                                         const uint32_t* row) {
  constexpr int W = 2 * G::ROWS;
  uint32_t w[W];
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 v = __ldg(q + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
  uint32_t* ys = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int j = 0; j < G::ROWS; ++j) {
    xs[j] = w[j];
    ys[j] = w[G::ROWS + j];
  }
}

// Lane (chunk) l = b M + m covers positions l K .. l K + K - 1 of the
// (B, n) idx / seg arrays, n = M K (scan_rows.cuh).  T threads a block,
// at least `BlocksPerSM` blocks an SM (the register cap).
template <class G, int T, int BlocksPerSM>
__global__ void __launch_bounds__(T, BlocksPerSM)
k_bucket_scan_rows(const uint32_t* __restrict__ rows,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ seg, uint32_t* tx,
                   uint32_t* ty, uint32_t* tz, uint32_t* bx, uint32_t* by,
                   uint32_t* bz, int32_t* flag, int K, int64_t lanes,
                   int64_t M, int nb) {
  extern __shared__ int32_t staged[];
  const int KP = K + 1;
  int32_t* s_idx = staged;
  int32_t* s_seg = staged + T * KP;
  const int64_t lane0 = (int64_t)blockIdx.x * T;
  const int nl = (int)min((int64_t)T, lanes - lane0);
  stage_chunks(s_idx, s_seg, idx, seg, lane0, nl, K, T, false);
  __syncthreads();
  if ((int)threadIdx.x >= nl) return;
  const int64_t lane = lane0 + threadIdx.x;
  const int32_t* my_idx = s_idx + threadIdx.x * KP;
  const int32_t* my_seg = s_seg + threadIdx.x * KP;
  const int64_t b = lane / M;
  const int32_t after = chunk_after(seg, lane, M, K, nb);
  const int64_t ncols = lanes / M * nb;
  constexpr int W = 2 * G::ROWS;
  using E = typename G::E;
  Jac<G> acc;
  bool collided = false;
  for (int t = 0; t < K; ++t) {
    E cx, cy;
    load_row<G>(cx, cy, rows + (int64_t)my_idx[t] * W);
    if (t > 0 && (!seg || my_seg[t] == my_seg[t - 1])) {
      bool same;
      jac_madd_inl<G>(acc, same, acc, cx, cy);
      collided |= same;
    } else {
      acc.X = cx;
      acc.Y = cy;
      if (G::is_zero(cx) && G::is_zero(cy))
        G::set_zero(acc.Z);
      else
        G::set_one(acc.Z);
    }
    if (nb) {
      const int32_t d = run_end(my_seg, t, K, after, nb);
      if (d >= 0) jac_store<G>(bx, by, bz, b * nb + d, ncols, acc);
    }
  }
  jac_store<G>(tx, ty, tz, lane, lanes, acc);
  flag[lane] = collided ? 1 : 0;
}

template <class G, int T, int BlocksPerSM>
int launch_scan_rows(const void* rows, const void* idx, const void* seg,
                     void* tx, void* ty, void* tz, void* bx, void* by,
                     void* bz, void* flag, int K, int64_t lanes, int64_t M,
                     int nb, cudaStream_t s) {
  const size_t smem = (size_t)T * (K + 1) * sizeof(int32_t) * (seg ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k_bucket_scan_rows<G, T, BlocksPerSM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_bucket_scan_rows<G, T, BlocksPerSM>
      <<<blocks_for(lanes, T), T, smem, s>>>(
      (const uint32_t*)rows, (const int32_t*)idx, (const int32_t*)seg,
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, (int32_t*)flag, K, lanes, M, nb);
  return (int)cudaGetLastError();
}


// The affine point (0, 0) = infinity as a Jacobian point.
template <class G>
__device__ __forceinline__ void jac_from_affine(Jac<G>& p,
                                                const typename G::E& x,
                                                const typename G::E& y) {
  p.X = x;
  p.Y = y;
  if (G::is_zero(x) && G::is_zero(y))
    G::set_zero(p.Z);
  else
    G::set_one(p.Z);
}

// K8's copy of a block's columns in shared memory: row r (W words) at
// r P, column c at c + c / 32 (one word of padding each 32, so the lanes
// of a warp, L columns apart, hit distinct banks).
__host__ __device__ constexpr int stage_pitch(int W) { return W + W / 32 + 1; }
__device__ __forceinline__ int stage_col(int c) { return c + (c >> 5); }

// K8: thread i of the grid is lane i % g of chunk i / g; T threads a
// block, at least BlocksPerSM blocks an SM (the register cap).  A block
// holds T / g chunks, W = T / g K consecutive columns from c0.  Without
// Stage it reads and writes device memory in place.  With Stage the
// block first copies rows X, Y and seg of its columns into shared memory
// with coalesced loads, phases 1 and 3 read them there, phase 3 writes
// each step's X and Y over the input it has just read (Z in place), and
// the block then copies X and Y out with coalesced stores.
template <class G, int T, int BlocksPerSM, bool Stage>
__global__ void __launch_bounds__(T, BlocksPerSM)
k_bucket_scan(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const int32_t* __restrict__ seg, uint32_t* ox, uint32_t* oy,
              uint32_t* oz, int32_t* flag, int K, int g, int64_t n) {
  using E = typename G::E;
  constexpr int R = G::ROWS;
  extern __shared__ uint32_t sm[];
  const int64_t M = n / K;
  const int64_t m = ((int64_t)blockIdx.x * T + threadIdx.x) / g;
  const int lane = threadIdx.x & (g - 1);
  const bool live = m < M;        // a group is live or idle as a whole
  const int L = K / g;
  const int64_t base = m * K + (int64_t)lane * L;
  const int W = T / g * K;
  const int P = stage_pitch(W);
  const int64_t c0 = (int64_t)blockIdx.x * W;
  const int w = (int)min((int64_t)W, n - c0);
  const uint32_t* sseg = sm + 2 * R * P;
  if (Stage) {
    for (int c = threadIdx.x; c < w; c += T) {
      uint32_t v[2 * R + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = __ldg(x + (int64_t)r * n + c0 + c);
        v[R + r] = __ldg(y + (int64_t)r * n + c0 + c);
      }
      v[2 * R] = (uint32_t)__ldg(seg + c0 + c);
      const int at = stage_col(c);
#pragma unroll
      for (int r = 0; r <= 2 * R; ++r) sm[r * P + at] = v[r];
    }
    __syncthreads();
  }
  auto load = [&](E& px, E& py, int64_t col) {
    if (Stage) {
      const uint32_t* s = sm + stage_col((int)(col - c0));
      G::load(px, s, P);
      G::load(py, s + R * P, P);
    } else {
      G::load(px, x + col, n);
      G::load(py, y + col, n);
    }
  };
  auto restart = [&](int64_t col) {
    if (col == m * K) return true;
    if (Stage) {
      const int c = (int)(col - c0);
      return sseg[stage_col(c)] != sseg[stage_col(c - 1)];
    }
    return seg[col] != seg[col - 1];
  };
  Jac<G> acc;
  G::set_zero(acc.X);
  G::set_zero(acc.Y);
  G::set_zero(acc.Z);
  E cx, cy;
  if (g > 1) {
    bool f = false;
    if (live) {
      for (int t = 0; t < L; ++t) {
        load(cx, cy, base + t);
        const bool rs = restart(base + t);
        if (t == 0 || rs) {
          jac_from_affine<G>(acc, cx, cy);
        } else {
          Jac<G> r;
          bool same;
          jac_madd_inl<G>(r, same, acc, cx, cy);
          if (same) {                // the doubling, off the accumulator
            const Jac<G> p = acc;
            Jac<G> d;
            jac_double<G>(d, p);
            r = d;
          }
          acc = r;
        }
        f = f || rs;
      }
    }
    for (int d = 1; d < g; d <<= 1) {
      Jac<G> o;
      jac_shfl_up<G>(o, acc, d, g);
      const bool fo = __shfl_up_sync(0xffffffffu, (int)f, d, g) != 0;
      if (lane >= d) {
        if (!f) {
          const Jac<G> q = acc;
          Jac<G> sum;
          jac_add<G>(sum, o, q);
          acc = sum;
        }
        f = f || fo;
      }
    }
    jac_shfl_up<G>(acc, acc, 1, g);      // the carry: lane l - 1's prefix
  }
  bool collided = false;
  if (live) {
    for (int t = 0; t < L; ++t) {
      const int64_t col = base + t;
      load(cx, cy, col);
      if (restart(col)) {
        jac_from_affine<G>(acc, cx, cy);
      } else {
        bool same;
        jac_madd_inl<G>(acc, same, acc, cx, cy);
        collided |= same;
      }
      if (Stage) {
        uint32_t* s = sm + stage_col((int)(col - c0));
        G::store(s, P, acc.X);
        G::store(s + R * P, P, acc.Y);
        G::store(oz + col, n, acc.Z);
      } else {
        jac_store<G>(ox, oy, oz, col, n, acc);
      }
    }
  }
  int any = collided ? 1 : 0;               // the chunk's flag: OR of lanes
  for (int d = g >> 1; d > 0; d >>= 1)
    any |= __shfl_xor_sync(0xffffffffu, any, d, g);
  if (live && lane == 0) flag[m] = any;
  if (Stage) {
    __syncthreads();
    for (int c = threadIdx.x; c < w; c += T) {
      const int at = stage_col(c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ox[(int64_t)r * n + c0 + c] = sm[r * P + at];
        oy[(int64_t)r * n + c0 + c] = sm[(R + r) * P + at];
      }
    }
  }
}

// Shared bytes of a staged K8 block of W columns: rows X, Y and seg.
template <class G>
constexpr size_t stage_bytes(int W) {
  return (size_t)(2 * G::ROWS + 1) * stage_pitch(W) * sizeof(uint32_t);
}

// Whether BlocksPerSM staged blocks of T threads fit an SM's 228 KB of
// shared memory (1 KB of it reserved a block).
template <class G, int T, int BlocksPerSM>
constexpr bool stage_fits(int K, int g) {
  return (stage_bytes<G>(T / g * K) + 1024) * BlocksPerSM <= 228 * 1024;
}

template <class G, int T, int BlocksPerSM, bool Stage>
int launch_scan(const void* x, const void* y, const void* seg, void* ox,
                void* oy, void* oz, void* flag, int K, int g, int64_t n,
                cudaStream_t s) {
  auto kern = k_bucket_scan<G, T, BlocksPerSM, Stage>;
  const size_t smem = Stage ? stage_bytes<G>(T / g * K) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks_for(n / K * g, T), T, smem, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)seg,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, K, g, n);
  return (int)cudaGetLastError();
}

// K5 for G2 on thread pairs (bucket_scan_g2.cu).
int launch_scan_rows_g2(const void* rows, const void* idx, const void* seg,
                        void* tx, void* ty, void* tz, void* bx, void* by,
                        void* bz, void* flag, int K, int64_t lanes,
                        int64_t M, int nb, cudaStream_t s);

}  // namespace zk

// rows (Nrows, 2 rows) 16-byte aligned; idx, seg (lanes / M, M K) int32,
// seg null for one segment per chunk; nb > 0 needs seg with ids in
// [0, nb).  Outputs: tails (rows, lanes), buckets (rows, lanes / M * nb)
// when nb > 0, flag (lanes,).
extern "C" int zk_bucket_scan_rows(int g2, const void* rows, const void* idx,
                                   const void* seg, void* tx, void* ty,
                                   void* tz, void* bx, void* by, void* bz,
                                   void* flag, int K, int64_t lanes,
                                   int64_t M, int nb, void* stream) {
  if (K < 1 || M < 1 || lanes % M || (nb && !seg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_scan_rows_g2(rows, idx, seg, tx, ty, tz, bx, by, bz,
                                   flag, K, lanes, M, nb, s);
  return zk::launch_scan_rows<zk::G1Field, 128, 4>(
      rows, idx, seg, tx, ty, tz, bx, by, bz, flag, K, lanes, M, nb, s);
}

// x, y: (rows, n) affine coordinates; seg (n,) sorted; n % K == 0; g
// lanes a chunk, a power of two dividing K, at most 32.  G1 2 blocks of
// 128 an SM (216 registers staged, 192 in place; no spill), staged where
// two blocks' copies fit an SM (K = 32: g >= 4) unless in_place; G2 3 of
// 64 (the register cap), in place.
extern "C" int zk_bucket_scan(int g2, const void* x, const void* y,
                              const void* seg, void* ox, void* oy, void* oz,
                              void* flag, int K, int g, int64_t n,
                              int in_place, void* stream) {
  if (K < 1 || n % K || g < 1 || g > 32 || (g & (g - 1)) || K % g)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_scan<zk::G2ByValue, 64, 3, false>(x, y, seg, ox, oy, oz,
                                                        flag, K, g, n, s);
  if (!in_place && zk::stage_fits<zk::G1ByValue, 128, 2>(K, g))
    return zk::launch_scan<zk::G1ByValue, 128, 2, true>(x, y, seg, ox, oy, oz,
                                                        flag, K, g, n, s);
  return zk::launch_scan<zk::G1ByValue, 128, 2, false>(x, y, seg, ox, oy, oz,
                                                       flag, K, g, n, s);
}
