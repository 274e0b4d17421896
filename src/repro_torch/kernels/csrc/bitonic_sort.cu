// Row-wise lex sort of (key, val) uint32 records: the map-task sort.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py
// bitonic_sort_blocks (body _sort_block_kernel / _bitonic_network), which
// sorts each (1, B) row inside VMEM. On the main path a row is up to
// B = 2^20 records (8 MiB of keys + vals), far beyond the 227 KB of shared
// memory a block can hold, so the network is split by compare distance:
//
//   * bitonic_tile: one block per TILE-record tile runs, in shared memory,
//     every substage whose distance is < TILE (the first call sorts tiles
//     for windows 2..TILE; later calls finish one window's small
//     distances);
//   * bitonic_global: one thread per compare pair in device memory, for
//     each substage of distance >= TILE.
//
// Direction follows the reference: a pair (i, i + d) inside stage window w
// sorts ascending iff (i & w) == 0, so the final window (w = B) is
// ascending. The order is total on (key, val), so the output is bit-equal
// to any other correct sort of the row.
//
// Bound on this card: bytes. The least traffic is one read and one write
// of 8 bytes per record; this design reads and writes the row once per
// global substage plus once per tile pass (for B = 2^20 and TILE = 2^12:
// 36 global substages and 9 tile passes), so it moves ~45x the least
// bytes. Later work: larger tiles via dynamic shared memory, and several
// global substages per pass.
#include "common.cuh"

namespace {

constexpr int TILE = 4096;     // records per shared tile: 32 KB keys + vals
constexpr int THREADS = 512;   // 4 compare pairs per thread per substage

__global__ void bitonic_tile(const uint32_t* kin, const uint32_t* vin,
                             uint32_t* kout, uint32_t* vout, long long b,
                             int tile, long long w_first, long long w_last,
                             long long d_first) {
  __shared__ uint32_t sk[TILE];
  __shared__ uint32_t sv[TILE];
  const long long tiles_per_row = b / tile;
  const long long row = blockIdx.x / tiles_per_row;
  const long long base = (blockIdx.x % tiles_per_row) * (long long)tile;
  const long long off = row * b + base;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = kin[off + t];
    sv[t] = vin[off + t];
  }
  __syncthreads();
  const int half = tile / 2;
  for (long long w = w_first; w <= w_last; w <<= 1) {
    for (long long d = (w == w_first) ? d_first : (w >> 1); d >= 1; d >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int dd = (int)d;  // a power of two: i = p with a 0 inserted at bit log2(d)
        const int i = ((p & ~(dd - 1)) << 1) | (p & (dd - 1));
        const int j = i + dd;
        const bool asc = ((base + i) & w) == 0;
        const uint32_t ki = sk[i], vi = sv[i], kj = sk[j], vj = sv[j];
        const bool swap = asc ? kv_greater(ki, vi, kj, vj)
                              : kv_greater(kj, vj, ki, vi);
        if (swap) {
          sk[i] = kj; sv[i] = vj;
          sk[j] = ki; sv[j] = vi;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    kout[off + t] = sk[t];
    vout[off + t] = sv[t];
  }
}

__global__ void bitonic_global(uint32_t* k, uint32_t* v, long long b,
                               long long pairs, long long w, long long d) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long half = b / 2;
  const long long row = t / half;
  const long long p = t % half;
  const long long i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
  const long long gi = row * b + i;
  const long long gj = gi + d;
  const bool asc = (i & w) == 0;
  const uint32_t ki = k[gi], vi = v[gi], kj = k[gj], vj = v[gj];
  const bool swap = asc ? kv_greater(ki, vi, kj, vj)
                        : kv_greater(kj, vj, ki, vi);
  if (swap) {
    k[gi] = kj; v[gi] = vj;
    k[gj] = ki; v[gj] = vi;
  }
}

}  // namespace

// Sort each row of (nb, b) (kin, vin) into (kout, vout); b a power of two.
RT_API int rt_bitonic_sort(const uint32_t* kin, const uint32_t* vin,
                           uint32_t* kout, uint32_t* vout, long long nb,
                           long long b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || b <= 0) return 0;
  const int tile = b < TILE ? (int)b : TILE;
  const int threads = tile / 2 < THREADS ? (tile / 2 > 0 ? tile / 2 : 1)
                                         : THREADS;
  const long long blocks = nb * (b / tile);
  bitonic_tile<<<(unsigned)blocks, threads, 0, s>>>(kin, vin, kout, vout, b,
                                                    tile, 2, tile, 1);
  RT_CHECK();
  const long long pairs = nb * (b / 2);
  const int gthreads = 256;
  const unsigned gblocks = (unsigned)((pairs + gthreads - 1) / gthreads);
  for (long long w = 2LL * tile; w <= b; w <<= 1) {
    for (long long d = w / 2; d >= tile; d >>= 1) {
      bitonic_global<<<gblocks, gthreads, 0, s>>>(kout, vout, b, pairs, w, d);
      RT_CHECK();
    }
    bitonic_tile<<<(unsigned)blocks, threads, 0, s>>>(kout, vout, kout, vout,
                                                      b, tile, w, w, tile / 2);
    RT_CHECK();
  }
  return 0;
}
