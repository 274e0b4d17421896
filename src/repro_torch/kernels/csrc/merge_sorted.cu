// Row-wise merge of two lex-sorted (key, val) uint32 runs:
// (n, L) + (n, L) -> (n, 2L).
//
// Replaces the TPU kernel src/repro/kernels/merge_sorted.py
// merge_sorted_pairs (body _merge_pair_kernel / _merge_network), which
// concatenates a with reversed b and runs one bitonic merge pass in VMEM.
// On the main path a run is up to L = 2^21 records (the stage-2 merge),
// so instead of a network this is a merge path: each thread owns ITEMS
// consecutive outputs, finds where its first output's diagonal crosses a
// and b by binary search on the (key, val) order (ties go to a), then
// merges ITEMS records sequentially. Records equal on (key, val) are
// bit-identical, so the tie rule cannot change the output: it equals the
// reference's network output on sorted rows.
//
// Bound on this card: bytes — each input record read once and each
// output written once (32 bytes per output pair of records). This design
// adds log2(L) search reads per thread and strided per-thread access;
// staging the search window in shared memory is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // outputs per thread

__global__ void merge_pairs(const uint32_t* ak, const uint32_t* av,
                            const uint32_t* bk, const uint32_t* bv,
                            uint32_t* ok, uint32_t* ov, long long n,
                            long long L, long long per_row) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = t / per_row;
  if (row >= n) return;
  const long long d = (t % per_row) * ITEMS;
  const uint32_t *a_k = ak + row * L, *a_v = av + row * L;
  const uint32_t *b_k = bk + row * L, *b_v = bv + row * L;
  uint32_t *o_k = ok + row * 2 * L, *o_v = ov + row * 2 * L;
  // Co-rank: how many of the first d outputs come from a.
  long long lo = d > L ? d - L : 0;
  long long hi = d < L ? d : L;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long bj = d - mid - 1;
    if (!kv_greater(a_k[mid], a_v[mid], b_k[bj], b_v[bj])) lo = mid + 1;
    else hi = mid;
  }
  long long i = lo, j = d - lo;
  const long long end = d + ITEMS < 2 * L ? d + ITEMS : 2 * L;
  for (long long o = d; o < end; ++o) {
    const bool take_a = j >= L ||
        (i < L && !kv_greater(a_k[i], a_v[i], b_k[j], b_v[j]));
    if (take_a) { o_k[o] = a_k[i]; o_v[o] = a_v[i]; ++i; }
    else        { o_k[o] = b_k[j]; o_v[o] = b_v[j]; ++j; }
  }
}

}  // namespace

RT_API int rt_merge_pairs(const uint32_t* ak, const uint32_t* av,
                          const uint32_t* bk, const uint32_t* bv,
                          uint32_t* ok, uint32_t* ov, long long n, long long L,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0) return 0;
  const long long per_row = (2 * L + ITEMS - 1) / ITEMS;
  const long long total = n * per_row;
  merge_pairs<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      ak, av, bk, bv, ok, ov, n, L, per_row);
  RT_CHECK();
  return 0;
}
