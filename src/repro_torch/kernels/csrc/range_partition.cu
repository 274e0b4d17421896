// Range-partition offsets: out[i, j] = #{k in row i : k < bounds[j]}.
//
// Replaces the TPU kernel src/repro/kernels/range_partition.py
// partition_offsets_blocks (body _partition_kernel), which streams each
// row through VMEM in 2048-key tiles and accumulates an (R,) compare
// count. The count needs no sortedness, so it is also right on unsorted
// rows, and duplicate boundaries simply give empty slices. That contract
// means every key is read: a search over sorted rows (torch.searchsorted,
// R log B reads) is not the same function.
//
// Bound on this card: bytes. The keys are read once, 4 bytes each: 32 MB
// for (8, 2^20), 0.010 ms at 3.35 TB/s. R is small on the main path
// (W - 1 = 7, or R1 - 1), so the R compares per key stay far below the
// integer rate. The design streams at that bound in one launch:
//
//   * the wrapper sizes the grid to fill the card (blocks_per_row blocks
//     for each row, about 4 per SM in all); each block takes one slice of
//     its row and reads it with 16-byte loads, four keys a thread a load
//     and UNROLL = 4 loads in flight (4-byte loads where the row is not
//     16-byte aligned);
//   * each thread keeps RG boundary counts in registers, RG the power of
//     two from 1 to MAXR = 16 that covers R (8 on the main path); a
//     larger R takes the keys again for each further 16 boundaries;
//   * the block sums by warp shuffle and shared memory and writes its
//     partial counts to a scratch row; the last block of a row to finish
//     (a ticket: __threadfence, then an atomic counter that it resets to
//     0) sums the row's partials in a fixed order into out. Integer sums,
//     so the result is exact; no memset, no atomics on the output.
//
// The wrapper owns the scratch (partials, and the tickets zeroed once)
// and reuses it on each call on the same stream; the kernel allocates
// nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXR = 16;  // boundaries counted per sweep of the keys
constexpr int UNROLL = 4;  // 16-byte loads a thread issues at once

__device__ __forceinline__ int lt(uint32_t k, uint32_t b) { return k < b; }

template <int RG>
__global__ void __launch_bounds__(THREADS)
partition_count(const uint32_t* keys, const uint32_t* bounds, int32_t* out,
                int32_t* partial, unsigned* tickets, long long b, int r,
                int blocks_per_row, bool vec) {
  __shared__ int red[WARPS][RG];
  __shared__ bool last;
  const long long row = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x % blocks_per_row;
  // this block's slice [lo, hi) of the row; a multiple of 4 keys long
  const long long per =
      ((b + blocks_per_row - 1) / blocks_per_row + 3) & ~3LL;
  const long long lo = part * per < b ? part * per : b;
  const long long hi = lo + per < b ? lo + per : b;
  const uint32_t* rk = keys + row * b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* mine = partial + (row * blocks_per_row + part) * r;
  for (int g0 = 0; g0 < r; g0 += RG) {
    const int rg = r - g0 < RG ? r - g0 : RG;
    uint32_t bj[RG];
    int c[RG];
#pragma unroll
    for (int j = 0; j < RG; ++j) {
      bj[j] = j < rg ? bounds[g0 + j] : 0u;  // k < 0 never counts
      c[j] = 0;
    }
    if (vec) {  // lo and hi are multiples of 4 and the row is aligned
      const uint4* q = reinterpret_cast<const uint4*>(rk + lo);
      const long long nq = (hi - lo) / 4;
      for (long long t0 = 0; t0 < nq; t0 += UNROLL * THREADS) {
        uint4 k[UNROLL];  // UNROLL loads in flight before any compare
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long t = t0 + u * THREADS + threadIdx.x;
          k[u] = t < nq ? __ldcs(q + t) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const bool ok = t0 + u * THREADS + threadIdx.x < nq;
#pragma unroll
          for (int j = 0; j < RG; ++j)
            c[j] += ok ? lt(k[u].x, bj[j]) + lt(k[u].y, bj[j]) +
                             lt(k[u].z, bj[j]) + lt(k[u].w, bj[j])
                       : 0;
        }
      }
    } else {
      for (long long t = lo + threadIdx.x; t < hi; t += THREADS) {
        const uint32_t k = rk[t];
#pragma unroll
        for (int j = 0; j < RG; ++j) c[j] += lt(k, bj[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RG; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        c[j] += __shfl_down_sync(0xffffffffu, c[j], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < RG; ++j) red[warp][j] = c[j];
    }
    __syncthreads();
    if (threadIdx.x < rg) {
      int sum = 0;
      for (int wp = 0; wp < WARPS; ++wp) sum += red[wp][threadIdx.x];
      mine[g0 + threadIdx.x] = sum;
    }
    __syncthreads();
  }
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[row], 1u) == (unsigned)blocks_per_row - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int32_t* rp = partial + row * blocks_per_row * r;
  for (int j = threadIdx.x; j < r; j += THREADS) {
    int sum = 0;
    for (int p = 0; p < blocks_per_row; ++p) sum += __ldcg(rp + p * r + j);
    out[row * r + j] = sum;
  }
  if (threadIdx.x == 0) tickets[row] = 0;  // ready for the next launch
}

}  // namespace

// keys (nb, b) uint32, bounds (r,) uint32 -> out (nb, r) int32, in one
// launch of nb * blocks_per_row blocks. partial holds nb * blocks_per_row
// * r int32; tickets nb zeroed uint32, left zeroed again.
RT_API int rt_partition_offsets(const uint32_t* keys, const uint32_t* bounds,
                                int32_t* out, int32_t* partial,
                                unsigned* tickets, long long nb, long long b,
                                int r, int blocks_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || r <= 0) return 0;
  if (b < 0 || blocks_per_row < 1) return (int)cudaErrorInvalidValue;
  const bool vec = b % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const unsigned blocks = (unsigned)(nb * blocks_per_row);
#define RT_PARTITION(RG)                                                   \
  partition_count<RG><<<blocks, THREADS, 0, s>>>(keys, bounds, out, partial, \
                                                 tickets, b, r,            \
                                                 blocks_per_row, vec)
  if (r <= 1) RT_PARTITION(1);
  else if (r <= 2) RT_PARTITION(2);
  else if (r <= 4) RT_PARTITION(4);
  else if (r <= 8) RT_PARTITION(8);
  else RT_PARTITION(MAXR);
#undef RT_PARTITION
  RT_CHECK();
  return 0;
}
