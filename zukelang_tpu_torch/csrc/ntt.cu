// The NTT kernel: K1's Montgomery product as the device function of a
// radix-2 NTT over Fr, with the witness reduction's pointwise steps fused
// into its loads and stores.
//
// Replaces, on the prove path, K1 (mont_mul_pallas,
// zukelang_tpu/ops/pallas_kernels.py:201) inside the XLA loop of the
// reference's NTT (zukelang_tpu/ops/ntt.py:85, a fori_loop of gather
// butterflies with one product a stage) and the XLA pointwise steps of its
// witness reduction (zukelang_tpu/engine/jax_engine.py:167-208: the gate
// evaluation, the coset scalings, h = (a b - c) / Z_H).
//
// Bound: the limb products (a butterfly is one Fr product, 136 limb
// products); the 2^16 transforms move about 2 MB each.  The reference's
// loop makes a launch of every stage; here a block keeps a tile of
// T = 2^11 points (64 KB, dynamic shared memory) and runs up to log T
// stages on it between two trips to device memory, so a transform of up
// to 2^22 points is two launches (one at or below 2^11).
//
// Layout: vector b of a batch is (8, N) limb-major at b * 8 N.  A pass
// runs the stages s0 .. s0 + ns - 1 (ns <= log T).  Those stages couple
// only points that agree in their low s0 bits and in their bits from
// s0 + ns up: a "column" q of 2^ns points, q = (high, low), point k of it
// at index low + (k << s0) + (high << (s0 + ns)).  A block takes
// C = T / 2^ns consecutive columns; its shared tile holds point k of
// column cc at k C + cc.  The first pass (s0 = 0) has one column of T
// contiguous points a block; a later pass has C columns strided by 2^s0.
//
// Two orders, so that the witness reduction never permutes its data:
//   * DIT (stages upward, Cooley-Tukey butterflies) takes bit-reversed
//     input to natural output;
//   * DIF (stages downward, Gentleman-Sande butterflies) takes natural
//     input to bit-reversed output.
// The stand-alone transforms permute on the way: an inverse transform is
// a DIT whose first load gathers x[bitrev(i)]; a forward one is a DIF
// whose last store scatters to bitrev(i).  The witness reduction is
//   gate evaluation -> DIT inverse -> a, b, c coefficients (natural);
//   coset scaling -> DIF forward -> evaluations in bit-reversed order;
//   (a b - c) / Z_H -> DIT inverse -> coset unscaling -> h,
// the evaluations never leaving bit-reversed order.  Every value is a
// canonical field element, so any order of the butterflies gives the
// words of the reference's transform.
//
// Fused steps (`pre` on the first pass's load, at the source index src =
// bitrev(i) with brev_in, else i; `post` on the last pass's store, at the
// output index i):
//   pre  = kLoad: in[b][src];  kGate: sum_t w[idx[t]] coef[t] over the
//          terms t = off[src] .. off[src + 1] - 1 of side b, each row its
//          own count (a ragged row walks only its terms; zero from n_gates
//          up);  kQuot: (in[0] in[1] - in[2])
//          zinv at src, the three vectors of `in` giving one output;
//          then times pre_tab[src] where given (the coset powers g^i);
//   post = times post_c (1/N) where post_const, then times post_tab[i]
//          (g^-i) where given; stored at bitrev(i) with brev_out.
#include "field.cuh"

namespace zk {

constexpr int kNttLogTile = 11;    // ntt.LOG_TILE in ops/ntt.py
constexpr int kNttThreads = 512;

enum NttPre { kLoad = 0, kGate = 1, kQuot = 2 };

// Mirrored field by field by ops/ntt.py `_NttArgs` (ctypes).
struct NttArgs {
  const uint32_t* in;        // (batch, 8, N); kQuot: (3, 8, N)
  uint32_t* out;             // (batch, 8, N)
  const uint32_t* tw;        // (8, N / 2): w^0 .. w^(N/2 - 1)
  const uint32_t* pre_tab;   // (8, N) or null
  const uint32_t* post_tab;  // (8, N) or null
  const int32_t* gate_off[3];    // kGate: (G + 1) row offsets of side b
  const int32_t* gate_idx[3];    // kGate: (nnz_b) witness column a term
  const uint32_t* gate_coef[3];  // kGate: (8, nnz_b)
  const uint32_t* w;             // kGate: (8, w_cols) witness
  int64_t gate_nnz[3];
  int64_t n_gates;
  int64_t w_cols;
  uint32_t zinv[8];
  uint32_t post_c[8];
  int32_t logn;
  int32_t batch;             // output vectors
  int32_t dif;
  int32_t pre;
  int32_t brev_in;
  int32_t brev_out;
  int32_t post_const;
  int32_t unused;
};

__device__ __forceinline__ uint32_t bitrev(uint32_t i, int logn) {
  return logn ? __brev(i) >> (32 - logn) : 0u;
}

__device__ __forceinline__ void load8(uint32_t* v, const uint32_t* base,
                                      int64_t stride, int64_t i) {
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = base[l * stride + i];
}

// Out of line: the fused steps run once a point, the butterflies'
// products (inlined) log T times.
static __device__ __noinline__ void fr_mul_call(uint32_t* r,
                                                const uint32_t* a,
                                                const uint32_t* b) {
  fp_mul<Fr>(r, a, b);
}

__device__ void ntt_prologue(uint32_t* v, const NttArgs& a, int b,
                             int64_t src, int64_t n) {
  if (a.pre == kGate) {
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = 0;
    if (src < a.n_gates) {
      const int64_t end = a.gate_off[b][src + 1];
      for (int64_t t = a.gate_off[b][src]; t < end; ++t) {
        uint32_t x[8], c[8];
        load8(x, a.w, a.w_cols, a.gate_idx[b][t]);
        load8(c, a.gate_coef[b], a.gate_nnz[b], t);
        fr_mul_call(x, x, c);
        fp_add<Fr>(v, v, x);
      }
    }
  } else if (a.pre == kQuot) {
    uint32_t y[8], z[8];
    load8(v, a.in, n, src);
    load8(y, a.in + 8 * n, n, src);
    load8(z, a.in + 16 * n, n, src);
    fr_mul_call(v, v, y);
    fp_sub<Fr>(v, v, z);
#pragma unroll
    for (int l = 0; l < 8; ++l) y[l] = a.zinv[l];
    fr_mul_call(v, v, y);
  } else {
    load8(v, a.in + (int64_t)b * 8 * n, n, src);
  }
  if (a.pre_tab != nullptr) {
    uint32_t t[8];
    load8(t, a.pre_tab, n, src);
    fr_mul_call(v, v, t);
  }
}

__device__ void ntt_epilogue(uint32_t* v, const NttArgs& a, int64_t i,
                             int64_t n) {
  uint32_t t[8];
  if (a.post_const) {
#pragma unroll
    for (int l = 0; l < 8; ++l) t[l] = a.post_c[l];
    fr_mul_call(v, v, t);
  }
  if (a.post_tab != nullptr) {
    load8(t, a.post_tab, n, i);
    fr_mul_call(v, v, t);
  }
}

__global__ void __launch_bounds__(kNttThreads)
k_ntt_pass(const __grid_constant__ NttArgs a, int s0, int ns, int first,
           int last) {
  extern __shared__ uint32_t tile[];           // [8][T]
  const int logn = a.logn;
  const int64_t n = 1ll << logn;
  const int log_t = min(logn, kNttLogTile);
  const int T = 1 << log_t;
  const int log_c = log_t - ns;                // C = T / 2^ns columns
  const int C = 1 << log_c;
  const int64_t per_vec = n >> log_t;
  const int b = (int)(blockIdx.x / per_vec);
  const int64_t q0 = (int64_t)(blockIdx.x % per_vec) * C;
  const int64_t low_mask = (1ll << s0) - 1;
  // global index of point k of the block's column cc
  auto index = [&](int k, int cc) -> int64_t {
    const int64_t q = q0 + cc;
    return (q & low_mask) + ((int64_t)k << s0) + ((q >> s0) << (s0 + ns));
  };

  const uint32_t* src_vec = a.in + (int64_t)b * 8 * n;
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const int64_t i = index(e >> log_c, e & (C - 1));
    uint32_t v[8];
    if (first)
      ntt_prologue(v, a, b,
                   a.brev_in ? (int64_t)bitrev((uint32_t)i, logn) : i, n);
    else
      load8(v, src_vec, n, i);
#pragma unroll
    for (int l = 0; l < 8; ++l) tile[l * T + e] = v[l];
  }
  __syncthreads();

  for (int t = 0; t < ns; ++t) {
    const int sp = a.dif ? ns - 1 - t : t;     // the stage within the pass
    const int s = s0 + sp;
    const int half = 1 << sp;
    for (int j = threadIdx.x; j < T / 2; j += blockDim.x) {
      const int cc = j & (C - 1);
      const int kk = j >> log_c;
      const int k = ((kk >> sp) << (sp + 1)) | (kk & (half - 1));
      const int e1 = (k << log_c) | cc;
      const int e2 = e1 + (half << log_c);
      const int64_t twi = (index(k, cc) & ((1ll << s) - 1)) << (logn - 1 - s);
      uint32_t u[8], v[8], w[8], d[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        u[l] = tile[l * T + e1];
        v[l] = tile[l * T + e2];
      }
      load8(w, a.tw, n >> 1, twi);
      if (a.dif) {            // (u + v, (u - v) w)
        fp_sub<Fr>(d, u, v);
        fp_add<Fr>(u, u, v);
        fp_mul<Fr>(v, d, w);
      } else {                // (u + v w, u - v w)
        fp_mul<Fr>(v, v, w);
        fp_sub<Fr>(d, u, v);
        fp_add<Fr>(u, u, v);
#pragma unroll
        for (int l = 0; l < 8; ++l) v[l] = d[l];
      }
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        tile[l * T + e1] = u[l];
        tile[l * T + e2] = v[l];
      }
    }
    __syncthreads();
  }

  uint32_t* dst_vec = a.out + (int64_t)b * 8 * n;
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    const int64_t i = index(e >> log_c, e & (C - 1));
    uint32_t v[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = tile[l * T + e];
    int64_t dst = i;
    if (last) {
      ntt_epilogue(v, a, i, n);
      if (a.brev_out) dst = bitrev((uint32_t)i, logn);
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) dst_vec[l * n + dst] = v[l];
  }
}

}  // namespace zk

// One pass of a transform: the stages s0 .. s0 + ns - 1, the fused
// prologue with `first`, the epilogue with `last`.  A pass that permutes
// (brev_in on its load, brev_out on its store) needs in != out; any other
// runs in place.
extern "C" int zk_ntt_pass(const zk::NttArgs* a, int s0, int ns, int first,
                           int last, void* stream) {
  const int logn = a->logn;
  const int log_t = logn < zk::kNttLogTile ? logn : zk::kNttLogTile;
  if (logn < 0 || logn > 30 || ns < 0 || ns > log_t || s0 < 0 ||
      s0 + ns > logn || a->batch < 1 || a->pre < zk::kLoad ||
      a->pre > zk::kQuot)
    return (int)cudaErrorInvalidValue;
  const int T = 1 << log_t;
  const int threads = T / 2 > zk::kNttThreads ? zk::kNttThreads
                      : (T / 2 < 32 ? 32 : T / 2);
  const size_t smem = 8 * sizeof(uint32_t) * (size_t)T;
  cudaError_t err = cudaFuncSetAttribute(
      zk::k_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(8 * sizeof(uint32_t) << zk::kNttLogTile));
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)a->batch << (logn - log_t);
  zk::k_ntt_pass<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      *a, s0, ns, first, last);
  return (int)cudaGetLastError();
}
