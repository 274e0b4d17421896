// Row-wise merge of two runs sorted on (key, val, idx): the reduce-side
// window merge. (n, L) x 3 operands + the same -> (n, 2L) x 3.
//
// Replaces the TPU kernel src/repro/kernels/kway_merge.py
// merge_sorted_pairs_indexed (body _merge_pair_indexed_kernel /
// _merge_network_idx): the same merge as merge_sorted.cu with a third,
// int32 ordinal operand compared last. The ordinal makes the order total
// (it is each record's position in the emit window, pads carry the
// window size), so the merge is stable and idx doubles as the gather
// index for the host-side payload rows.
//
// Design: merge path, as in merge_sorted.cu — each thread owns ITEMS
// consecutive outputs, binary-searches its diagonal on the triple order,
// then merges sequentially. The tournament over K runs stays in the
// Python wrapper (kway_merge_indexed), as in the reference.
//
// Bound on this card: bytes — 12 bytes per record read once from a and b
// and written once. Emit windows are small (tens of thousands of records
// on the main path), so launch latency, not bandwidth, dominates a call.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;

__global__ void merge_pairs_indexed(const uint32_t* ak, const uint32_t* av,
                                    const int32_t* ai, const uint32_t* bk,
                                    const uint32_t* bv, const int32_t* bi,
                                    uint32_t* ok, uint32_t* ov, int32_t* oi,
                                    long long n, long long L,
                                    long long per_row) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = t / per_row;
  if (row >= n) return;
  const long long d = (t % per_row) * ITEMS;
  const long long ra = row * L, ro = row * 2 * L;
  long long lo = d > L ? d - L : 0;
  long long hi = d < L ? d : L;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long bj = d - mid - 1;
    if (!kvi_greater(ak[ra + mid], av[ra + mid], ai[ra + mid],
                     bk[ra + bj], bv[ra + bj], bi[ra + bj])) lo = mid + 1;
    else hi = mid;
  }
  long long i = lo, j = d - lo;
  const long long end = d + ITEMS < 2 * L ? d + ITEMS : 2 * L;
  for (long long o = d; o < end; ++o) {
    const bool take_a = j >= L ||
        (i < L && !kvi_greater(ak[ra + i], av[ra + i], ai[ra + i],
                               bk[ra + j], bv[ra + j], bi[ra + j]));
    if (take_a) {
      ok[ro + o] = ak[ra + i]; ov[ro + o] = av[ra + i]; oi[ro + o] = ai[ra + i];
      ++i;
    } else {
      ok[ro + o] = bk[ra + j]; ov[ro + o] = bv[ra + j]; oi[ro + o] = bi[ra + j];
      ++j;
    }
  }
}

}  // namespace

RT_API int rt_merge_pairs_indexed(const uint32_t* ak, const uint32_t* av,
                                  const int32_t* ai, const uint32_t* bk,
                                  const uint32_t* bv, const int32_t* bi,
                                  uint32_t* ok, uint32_t* ov, int32_t* oi,
                                  long long n, long long L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0) return 0;
  const long long per_row = (2 * L + ITEMS - 1) / ITEMS;
  const long long total = n * per_row;
  merge_pairs_indexed<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                        0, s>>>(ak, av, ai, bk, bv, bi, ok, ov, oi, n, L,
                                per_row);
  RT_CHECK();
  return 0;
}
