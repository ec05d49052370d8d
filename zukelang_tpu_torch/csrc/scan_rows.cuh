// K5's chunk control, shared by its two kernels (bucket_scan.cu's
// k_bucket_scan_rows, one thread a lane on G1; bucket_scan_g2.cu's
// k_bucket_scan_rows_g2, a thread pair a lane on G2): a block stages its
// lanes' indices and segment ids, and each lane reads from them where a
// bucket's in-chunk run ends.
//
// Lane (chunk) l = b M + m covers positions l K .. l K + K - 1 of the
// (B, n) idx / seg arrays, n = M K; b is its block row.  Functions, not a
// lane object: each kernel keeps its own pointers to its staged rows (a
// struct holding them, with a seg test in the G2 loop, compiled G1 to one
// register more and G2 to 32 B of spill; PERF.md section 6).
#pragma once

#include <cstdint>

namespace zk {

// Stages the K indices and segment ids of the block's nl lanes from lane0
// on in shared memory, by all nthreads threads with coalesced loads: a
// lane's row at K + 1 words (the padding puts the lanes' reads in
// distinct banks).  With seg null (one segment a chunk) s_seg is zeroed
// if zero_fill, else left unset.
__device__ __forceinline__ void stage_chunks(int32_t* s_idx, int32_t* s_seg,
                                             const int32_t* idx,
                                             const int32_t* seg,
                                             int64_t lane0, int nl, int K,
                                             int nthreads, bool zero_fill) {
  const int KP = K + 1;
  const int64_t first = lane0 * K;
  for (int i = threadIdx.x; i < nl * K; i += nthreads) {
    const int l = i / K;
    const int at = l * KP + i - l * K;
    s_idx[at] = idx[first + i];
    if (seg)
      s_seg[at] = seg[first + i];
    else if (zero_fill)
      s_seg[at] = 0;
  }
}

// The segment id after a lane's last step: the next chunk's first in the
// same block row, else -1 (the row ends; always with nb = 0).
__device__ __forceinline__ int32_t chunk_after(const int32_t* seg,
                                               int64_t lane, int64_t M,
                                               int K, int nb) {
  return nb && lane % M + 1 < M ? seg[(lane + 1) * K] : -1;
}

// The bucket whose in-chunk run ends at step t of a lane's staged segment
// ids my_seg: its id d where the next step's (or `after`) differs and
// 0 <= d < nb, else -1.
__device__ __forceinline__ int32_t run_end(const int32_t* my_seg, int t,
                                           int K, int32_t after, int nb) {
  const int32_t d = my_seg[t];
  return (t + 1 < K ? my_seg[t + 1] : after) != d && d >= 0 && d < nb ? d
                                                                       : -1;
}

}  // namespace zk
