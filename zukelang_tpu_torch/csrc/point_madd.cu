// K3: batched mixed add, Jacobian p + affine q with (0, 0) = infinity,
// over G1 and G2.  Replaces point_madd_pallas / point_madd_pallas_g2
// (zukelang_tpu/ops/pallas_kernels.py:663, :680; kernels
// _point_madd_kernel / _point_madd_kernel2 :594, :615): madd-2007-bl.
//
// Two kernels:
//   * k_point_madd, the Pallas contract: one thread a lane, the output
//     and the per-lane doubling flag as the Pallas kernel leaves them (a
//     flagged lane holds the formula's garbage; ops.curve.point_madd
//     fixes it with K2's doubling).
//   * k_point_madd_chain, the paths' form: lane e starts from an affine
//     point and adds `steps - 1` more in one launch, the accumulator in
//     registers, the doubling case resolved in the kernel (its words are
//     those of K3 followed by the fix-up, step by step).  Its points are
//     either entries of a fixed-base window table, gathered in the kernel
//     from the digits (column (w << c) + d_w at step w), or the lane's
//     chunk of a flat batch (column e * steps + w), where a step restarts
//     from its point where the segment id changes and every step's sum
//     is stored (phase 1 of the chunked bucket sums).
// Bound: latency.  On its paths the chain has 15 (a keygen batch of 16
// lanes) or 31 steps (8,192 chunk lanes), each 11 dependent coordinate
// products at one thread a lane; a loop of launches made one launch, one
// host read of the flags and one chain a step.  The chain runs on a group
// of L lanes a point, fixed per group (point_lanes.cuh: 5 Fq products a
// step at L = 4 for G1, L = 8 for G2; kernels.MADD_CHAIN_LANES).
#include "point_lanes.cuh"

namespace zk {

constexpr int kMaddThreads = 128;

template <class G>
__global__ void __launch_bounds__(kMaddThreads)
k_point_madd(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
             const uint32_t* x2, const uint32_t* y2, uint32_t* ox,
             uint32_t* oy, uint32_t* oz, int32_t* flag, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p, r;
  typename G::E qx, qy;
  jac_load<G>(p, x1, y1, z1, i, n);
  G::load(qx, x2 + i, n);
  G::load(qy, y2 + i, n);
  bool same;
  jac_madd<G>(r, same, p, qx, qy);
  jac_store<G>(ox, oy, oz, i, n, r);
  flag[i] = same ? 1 : 0;
}

// Table (tx, ty): affine coordinates (rows, ncols).  digits (steps, n):
// step w of lane e takes column (w << c) + digits[w][e]; without digits
// column e * steps + w, and with seg (ncols,) the sum restarts at step w
// where seg differs from step w - 1's.  keep: every step's sum into
// column e * steps + w of (rows, n * steps) outputs; else the last into
// column e of (rows, n).
constexpr int kChainLanesG1 = 4, kChainLanesG2 = 8;

template <class G, int L>
__global__ void __launch_bounds__(kMaddThreads)
k_point_madd_chain(const uint32_t* tx, const uint32_t* ty, int64_t ncols,
                   const int32_t* digits, int c, const int32_t* seg,
                   int steps, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                   int64_t n, int keep) {
  const LaneGroup<L> lg;
  const int64_t e = lg.point();
  const bool live = lg.in_group() && e < n;
  const int64_t ostride = keep ? n * steps : n;
  Jac<G> acc;
  jac_zero(acc);
  for (int w = 0; w < steps; ++w) {
    typename G::E qx, qy;
    G::set_zero(qx);
    G::set_zero(qy);
    const int64_t at = e * steps + w;
    if (live) {
      const int64_t col =
          digits ? ((int64_t)w << c) + digits[(int64_t)w * n + e] : at;
      G::load(qx, tx + col, ncols);
      G::load(qy, ty + col, ncols);
    }
    bool restart = w == 0;
    if (w > 0) {
      Jac<G> r;
      madd_lanes<G, L>(r, acc, qx, qy, lg.sub, lg.base);
      restart = live && seg != nullptr && seg[at] != seg[at - 1];
      if (!restart) acc = r;
    }
    if (restart) {           // the step's point as a Jacobian point
      acc.X = qx;
      acc.Y = qy;
      if (G::is_zero(qx) && G::is_zero(qy))
        G::set_zero(acc.Z);
      else
        G::set_one(acc.Z);
    }
    if (keep && live && lg.sub == 0) jac_store<G>(ox, oy, oz, at, ostride, acc);
  }
  if (!keep && live && lg.sub == 0) jac_store<G>(ox, oy, oz, e, n, acc);
}

template <class G, int L>
int launch_chain(const void* tx, const void* ty, int64_t ncols,
                 const void* digits, int c, const void* seg, int steps,
                 void* ox, void* oy, void* oz, int64_t n, int keep,
                 cudaStream_t s) {
  constexpr int P = 32 / L;
  const unsigned blocks = blocks_for((n + P - 1) / P * 32, kMaddThreads);
  k_point_madd_chain<G, L><<<blocks, kMaddThreads, 0, s>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, ncols,
      (const int32_t*)digits, c, (const int32_t*)seg, steps, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n, keep);
  return (int)cudaGetLastError();
}

}  // namespace zk

extern "C" int zk_point_madd(int g2, const void* x1, const void* y1,
                             const void* z1, const void* x2, const void* y2,
                             void* ox, void* oy, void* oz, void* flag,
                             int64_t n, void* stream) {
  const unsigned blocks = zk::blocks_for(n, zk::kMaddThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    zk::k_point_madd<zk::G2Field><<<blocks, zk::kMaddThreads, 0, s>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, n);
  else
    zk::k_point_madd<zk::G1Field><<<blocks, zk::kMaddThreads, 0, s>>>(
        (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, (int32_t*)flag, n);
  return (int)cudaGetLastError();
}

// n lanes of `steps` mixed adds (see k_point_madd_chain).
extern "C" int zk_point_madd_chain(int g2, const void* tx, const void* ty,
                                   int64_t ncols, const void* digits, int c,
                                   const void* seg, int steps, void* ox,
                                   void* oy, void* oz, int64_t n, int keep,
                                   void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    return zk::launch_chain<zk::G2Field, zk::kChainLanesG2>(
        tx, ty, ncols, digits, c, seg, steps, ox, oy, oz, n, keep, s);
  return zk::launch_chain<zk::G1Field, zk::kChainLanesG1>(
      tx, ty, ncols, digits, c, seg, steps, ox, oy, oz, n, keep, s);
}
