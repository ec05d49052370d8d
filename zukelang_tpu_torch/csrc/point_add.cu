// K2's add: batched Jacobian add-2007-bl with every special case, over G1
// and G2.  Replaces point_add_pallas / point_add_pallas_g2
// (zukelang_tpu/ops/pallas_kernels.py:346, :529; bodies _point_add_kernel
// :272, :452).
//
// Bound: latency.  Most of the add's launches on the provers' paths are
// narrow: a Hillis-Steele round over 5 to 80 points, a carry add of 160
// to 5,120 chunks.  At one thread a point an add is a chain of 16
// dependent coordinate products (48 Fq products for G2), and a few dozen
// points leave the card empty.  So the add runs on a group of L lanes a
// point (point_lanes.cuh: the levels of add-2007-bl's independent
// products split over the group, a chain of 5 Fq products for G1 at L = 4
// and 8 for G2 at L = 8); L comes from `kernels.point_lanes`, a pure
// function of the group and the width, and wide launches take one thread
// a point (jac_add).  Three launch forms of that device function:
//   (a)/(c) k_point_add: out[i] = p[i] + q[j], j = i, or j = idx[i] with
//       idx[i] < 0 adding nothing (q at infinity): the carry add of a
//       chunked scan with its selection in the kernel, in place of the
//       gathers and selects that built a full-width second operand;
//   (b) k_seg_scan_small: the Hillis-Steele segmented scan of up to 256
//       points in one block, the rounds on points held in shared memory
//       (a double buffer, a barrier between rounds), in place of one
//       launch and a roll and select a round; its words are the rounds'.
#include "point_lanes.cuh"

namespace zk {

constexpr int kAddThreads = 128;
constexpr int kScanSmallThreads = 256;
constexpr int kScanSmallMax = 256;   // points of one form (b) launch

template <class G, int L>
__global__ void __launch_bounds__(kAddThreads)
k_point_add(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
            const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
            const int32_t* idx, uint32_t* ox, uint32_t* oy, uint32_t* oz,
            int64_t n, int64_t nq) {
  const LaneGroup<L> lg;
  const int64_t i = lg.point();
  const bool live = lg.in_group() && i < n;
  if constexpr (L == 1) {
    if (!live) return;
  }
  Jac<G> p, q, r;
  jac_zero(p);
  jac_zero(q);
  bool need = false;
  if (live) {
    jac_load<G>(p, x1, y1, z1, i, n);
    const int64_t j = idx ? (int64_t)idx[i] : i;
    need = j >= 0;
    if (need) jac_load<G>(q, x2, y2, z2, j, nq);
  }
  add_lanes_if<G, L>(r, p, q, need, lg.sub, lg.base);
  if (live && lg.sub == 0) jac_store<G>(ox, oy, oz, i, n, r);
}

// One block.  Shared memory: two buffers of n points, point-major (the 3 R
// words of point i at i * 3 R), then the n segment ids.
template <class G, int L>
__global__ void __launch_bounds__(kScanSmallThreads)
k_seg_scan_small(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                 const int32_t* seg, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                 int n) {
  extern __shared__ uint32_t zk_smem[];
  constexpr int R = G::ROWS;
  constexpr int W = 3 * R;
  uint32_t* buf[2] = {zk_smem, zk_smem + n * W};
  int32_t* sg = (int32_t*)(zk_smem + 2 * n * W);
  for (int t = threadIdx.x; t < n * W; t += blockDim.x) {
    const int k = t / n, i = t - k * n;
    const uint32_t* src = k < R ? x : (k < 2 * R ? y : z);
    buf[0][i * W + k] = src[(k % R) * n + i];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) sg[t] = seg[t];
  __syncthreads();
  const LaneGroup<L> lg;
  const int warp = threadIdx.x >> 5;
  const int per_round = (blockDim.x >> 5) * LaneGroup<L>::P;
  int cur = 0;
  for (int sh = 1; sh < n; sh <<= 1) {
    const uint32_t* src = buf[cur];
    uint32_t* dst = buf[cur ^ 1];
    for (int i0 = warp * LaneGroup<L>::P; i0 < n; i0 += per_round) {
      const int i = i0 + lg.g;
      const bool live = lg.in_group() && i < n;
      Jac<G> p, q, r;
      jac_zero(p);
      jac_zero(q);
      bool need = false;
      if (live) {
        const uint32_t* pi = src + i * W;
        jac_load<G>(p, pi, pi + R, pi + 2 * R, 0, 1);
        // the previous round's point i - sh, where it is in i's segment
        need = i >= sh && sg[i] == sg[i - sh];
        if (need) {
          const uint32_t* qi = src + (i - sh) * W;
          jac_load<G>(q, qi, qi + R, qi + 2 * R, 0, 1);
        }
      }
      add_lanes_if<G, L>(r, p, q, need, lg.sub, lg.base);
      if (live && lg.sub == 0) {
        uint32_t* di = dst + i * W;
        jac_store<G>(di, di + R, di + 2 * R, 0, 1, r);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int t = threadIdx.x; t < n * W; t += blockDim.x) {
    const int k = t / n, i = t - k * n;
    uint32_t* dst = k < R ? ox : (k < 2 * R ? oy : oz);
    dst[(k % R) * n + i] = buf[cur][i * W + k];
  }
}

template <class G, int L>
int launch_add(const uint32_t* const* in, const int32_t* idx,
               uint32_t* const* out, int64_t n, int64_t nq, cudaStream_t s) {
  constexpr int P = 32 / L;
  const unsigned blocks = blocks_for((n + P - 1) / P * 32, kAddThreads);
  k_point_add<G, L><<<blocks, kAddThreads, 0, s>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], idx, out[0], out[1], out[2],
      n, nq);
  return (int)cudaGetLastError();
}

template <class G, int L>
int launch_scan_small(const uint32_t* const* in, const int32_t* seg,
                      uint32_t* const* out, int n, cudaStream_t s) {
  constexpr int P = 32 / L;
  const int warps = (n + P - 1) / P;
  const int threads = warps * 32 < kScanSmallThreads ? warps * 32
                                                     : kScanSmallThreads;
  const size_t smem = (size_t)(2 * n * 3 * G::ROWS + n) * 4;
  cudaError_t rc = cudaFuncSetAttribute(
      k_seg_scan_small<G, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  k_seg_scan_small<G, L><<<1, threads, smem, s>>>(
      in[0], in[1], in[2], seg, out[0], out[1], out[2], n);
  return (int)cudaGetLastError();
}

}  // namespace zk

// The lane widths built: G1 1, 4; G2 1, 4, 8 lanes a point.
#define ZK_LANES_DISPATCH(g2, lanes, call)                          \
  do {                                                              \
    if (g2) {                                                       \
      if (lanes == 1) return call(zk::G2Field, 1);                  \
      if (lanes == 4) return call(zk::G2Field, 4);                  \
      if (lanes == 8) return call(zk::G2Field, 8);                  \
    } else {                                                        \
      if (lanes == 1) return call(zk::G1Field, 1);                  \
      if (lanes == 4) return call(zk::G1Field, 4);                  \
    }                                                               \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)

// out[i] = p[i] + q[j] (coordinates (rows, n), q's (rows, nq)): j = i
// without idx (nq = n), else j = idx[i], nothing added where idx[i] < 0.
extern "C" int zk_point_add(int g2, const void* x1, const void* y1,
                            const void* z1, const void* x2, const void* y2,
                            const void* z2, const void* idx, void* ox,
                            void* oy, void* oz, int64_t n, int64_t nq,
                            int lanes, void* stream) {
  const uint32_t* in[6] = {(const uint32_t*)x1, (const uint32_t*)y1,
                           (const uint32_t*)z1, (const uint32_t*)x2,
                           (const uint32_t*)y2, (const uint32_t*)z2};
  uint32_t* out[3] = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
  cudaStream_t s = (cudaStream_t)stream;
#define ZK_ADD(G, L) \
  zk::launch_add<G, L>(in, (const int32_t*)idx, out, n, nq, s)
  ZK_LANES_DISPATCH(g2, lanes, ZK_ADD);
#undef ZK_ADD
}

// Inclusive segmented prefix sum of n <= 256 points (seg sorted), the
// Hillis-Steele rounds of msm._hs_segmented_scan in one block.
extern "C" int zk_seg_scan_small(int g2, const void* x, const void* y,
                                 const void* z, const void* seg, void* ox,
                                 void* oy, void* oz, int n, int lanes,
                                 void* stream) {
  if (n < 1 || n > zk::kScanSmallMax) return (int)cudaErrorInvalidValue;
  const uint32_t* in[3] = {(const uint32_t*)x, (const uint32_t*)y,
                           (const uint32_t*)z};
  uint32_t* out[3] = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
  cudaStream_t s = (cudaStream_t)stream;
#define ZK_SCAN(G, L) \
  zk::launch_scan_small<G, L>(in, (const int32_t*)seg, out, n, s)
  ZK_LANES_DISPATCH(g2, lanes, ZK_SCAN);
#undef ZK_SCAN
}
