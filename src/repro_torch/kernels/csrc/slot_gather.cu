// The through mode's gather by arrival slot: for each merged slot (d, i)
// of the (wl, m) slots the merge returns, the record's id and its payload
// row, in merged order (core/payload.gather_by_slot).
//
// Replaces no TPU kernel: the reference joins the payload to the merge in
// XLA (an id join: a stable sort and a binary search, then a gather), and
// the port's plain version is a composition of aten ops (the row table,
// the pad fix-up, the worker offset, two index gathers and the row
// gather: six passes over 2^27 entries at the benchmark's shape, five
// int32 index arrays written and read back). Here the index work is done
// in registers and each row is copied once.
//
// Bound on this card: bytes. Written: S rows of pw words and S ids;
// read: the S merged slots and each of the R input rows once (without a
// mesh R = W_src * n). At the benchmark's S = 2^27, R = 2^26, pw = 23
// that is 19.6 GB, 5.86 ms at 3.35 TB/s. The rows' reads set the pace:
// each 92-byte source row lies at a random place of its producer's input
// and at 4-byte alignment, so it costs 3 or 4 sectors of 32 bytes; the
// writes are one contiguous stream. On an H100 SXM at 700 W the kernel
// takes 8.68 ms there (67% of that bound), the aten composition 14.72;
// writing the 12.35 GB of output rows alone takes 3.76 ms. The design:
//
//   * each warp owns 32 consecutive output slots; each lane reads its
//     slot (a pad becomes its worker's first pad of arrival order, found
//     from the worker's row of rcounts), the id in that slot, and works
//     out the slot's source row: without a mesh producer p = s / C's
//     input row p*n + min((id - p*n) mod 2^32, n - 1), on a mesh the
//     received row d*m + s. Offsets are 64-bit;
//   * the warp then copies its 32 rows as 32 * pw consecutive output
//     words: lane l takes words l, l + 32, ...; the word's row and column
//     are stepped without a division, and the row's source offset comes
//     from the lane that owns it by a shuffle. Neighbouring lanes read
//     neighbouring words of a source row, and UNROLL loads are issued
//     before the first store, so many row reads are in flight (more,
//     or 16-byte stores, or a persistent grid that prefetches the next
//     slots, all timed slower on the card); the stores are whole
//     128-byte lines. Every pad slot of a worker reads one row, which
//     stays in the L1 and L2.
//
// TMA does not fit a gather of rows at 4-byte alignment. A slot that is
// neither the pad nor below m is no merge's output: the kernel traps, as
// an out-of-range index traps index_select.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // words a lane loads before it stores them
constexpr uint32_t PAD = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Gather {
  const uint32_t* recv_ids;  // (wl, m) arrival order
  const uint32_t* rows;      // (w_src, n, pw) input or (wl * m, pw) received
  const uint32_t* slots;     // (wl, m) the merge's arrival slots
  const int32_t* rcounts;    // (wl, w_src)
  uint32_t* ids_out;         // (wl, m)
  uint32_t* rows_out;        // (wl, m, pw)
  long long total, m;        // total = wl * m
  int w_src;
  long long cap, n;          // cap = m / w_src; n rows a producer
  int pw;
  bool from_input;
};

// Slot s of worker d, a pad replaced by the worker's first pad of
// arrival order: block p's slot p*cap + rcounts[d, p] for the first p
// with rcounts[d, p] < cap; m - 1 where every block is full.
__device__ __forceinline__ uint32_t fix_pad(const Gather& a, long long d,
                                            uint32_t s) {
  if (s == PAD) {
    long long first = a.m - 1;
    const int32_t* rc = a.rcounts + d * a.w_src;
    for (int p = 0; p < a.w_src; ++p) {
      const long long c = rc[p];
      if (c < a.cap) {
        first = p * a.cap + c;
        break;
      }
    }
    return (uint32_t)first;
  }
  if (s >= a.m) __trap();
  return s;
}

// The source row of slot s of worker d, whose id is `id`.
__device__ __forceinline__ long long source_row(const Gather& a, long long d,
                                                uint32_t s, uint32_t id) {
  if (a.from_input) {
    const long long lo = (long long)(s / a.cap) * a.n;
    const long long off = (uint32_t)(id - (uint32_t)lo);
    return lo + (off < a.n - 1 ? off : a.n - 1);
  }
  return d * a.m + s;
}

// The warp's rows g0 .. g0 + 31 (fewer at the end) as consecutive output
// words; lane l's src is the source row of output row g0 + l.
__device__ __forceinline__ void copy_rows(const Gather& a, long long g0,
                                          long long src, int lane) {
  const int pw = a.pw;
  const long long words = (a.total - g0 < 32 ? a.total - g0 : 32) * pw;
  uint32_t* out = a.rows_out + g0 * pw;
  const int dr = 32 / pw, dk = 32 % pw;
  int r = lane / pw, k = lane % pw;  // word lane + 32j is (r, k) of row r
  for (long long t0 = 0; t0 < words; t0 += 32 * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = __shfl_sync(FULL, src, r & 31);
      v[u] = t0 + u * 32 + lane < words ? __ldg(a.rows + row * pw + k) : 0u;
      r += dr;
      k += dk;
      if (k >= pw) {
        k -= pw;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long t = t0 + u * 32 + lane;
      if (t < words) out[t] = v[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS) gather_slot_rows(Gather a) {
  const int lane = threadIdx.x & 31;
  const long long g0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  if (g0 >= a.total) return;  // the whole warp leaves together
  const long long g = g0 + lane;
  long long src = 0;
  if (g < a.total) {
    const long long d = g / a.m;
    const uint32_t s = fix_pad(a, d, __ldcs(a.slots + g));
    const uint32_t id = __ldg(a.recv_ids + d * a.m + s);
    a.ids_out[g] = id;
    src = source_row(a, d, s, id);
  }
  copy_rows(a, g0, src, lane);
}

}  // namespace

// recv_ids (wl, m) uint32 in arrival order, slots (wl, m) the merge's
// arrival slots, rcounts (wl, w_src) int32 -> ids_out (wl, m) and rows_out
// (wl, m, pw), in one launch. from_input: rows is the producers' input,
// (w_src, n, pw); else the received blocks, (wl * m, pw).
RT_API int rt_gather_slot_rows(const uint32_t* recv_ids, const uint32_t* rows,
                               const uint32_t* slots, const int32_t* rcounts,
                               uint32_t* ids_out, uint32_t* rows_out,
                               long long wl, long long m, long long w_src,
                               long long n, long long pw, int from_input,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = wl * m;
  if (total <= 0) return 0;
  if (w_src < 1 || m % w_src != 0 || pw < 1 || pw > (1 << 30) ||
      (from_input && n < 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Gather a{recv_ids, rows,  slots,         rcounts, ids_out,
                 rows_out, total, m,             (int)w_src, m / w_src,
                 n,        (int)pw, from_input != 0};
  gather_slot_rows<<<(unsigned)blocks, THREADS, 0, st>>>(a);
  RT_CHECK();
  return 0;
}
