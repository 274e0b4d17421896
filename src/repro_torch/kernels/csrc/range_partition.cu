// Range-partition offsets: out[i, j] = #{k in row i : k < bounds[j]}.
//
// Replaces the TPU kernel src/repro/kernels/range_partition.py
// partition_offsets_blocks (body _partition_kernel), which streams each
// row through VMEM in 2048-key tiles and accumulates an (R,) compare
// count. The count needs no sortedness, so it is also right on unsorted
// rows, and duplicate boundaries simply give empty slices.
//
// Here a grid of (row, key tile) blocks runs in parallel: each thread
// holds ITEMS keys of its tile in registers (coalesced loads), counts
// k < b_j for every boundary, the warp sums by shuffle, the block sums in
// shared memory, and one integer atomicAdd per (block, boundary) lands in
// the int32 output. Integer atomics commute, so the result is exact and
// deterministic. The wrapper's output comes from torch.empty; the C entry
// point zeroes it on the same stream first.
//
// Bound on this card: bytes. The keys are read once (4 bytes each) and R
// is small on the main path (W - 1 = 7, or R1 - 1), so the R compares per
// key are far below the integer rate.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                 // keys per thread
constexpr int TILE_KEYS = THREADS * ITEMS;  // 4096 keys per block

__global__ void partition_count(const uint32_t* keys, const uint32_t* bounds,
                                int32_t* out, long long b, int r,
                                long long tiles_per_row) {
  extern __shared__ int32_t cnt[];
  const long long row = blockIdx.x / tiles_per_row;
  const long long base = (blockIdx.x % tiles_per_row) * TILE_KEYS;
  for (int j = threadIdx.x; j < r; j += blockDim.x) cnt[j] = 0;
  uint32_t k[ITEMS];
  bool valid[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const long long idx = base + it * THREADS + threadIdx.x;
    valid[it] = idx < b;
    k[it] = valid[it] ? keys[row * b + idx] : 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < r; ++j) {
    const uint32_t bj = bounds[j];
    int c = 0;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) c += (valid[it] && k[it] < bj) ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0 && c) atomicAdd(&cnt[j], c);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    if (cnt[j]) atomicAdd(&out[row * r + j], cnt[j]);
  }
}

}  // namespace

// keys (nb, b) uint32, bounds (r,) uint32 -> out (nb, r) int32.
RT_API int rt_partition_offsets(const uint32_t* keys, const uint32_t* bounds,
                                int32_t* out, long long nb, long long b, int r,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || r <= 0) return 0;
  cudaMemsetAsync(out, 0, sizeof(int32_t) * nb * r, s);
  RT_CHECK();
  if (b <= 0) return 0;
  const size_t smem = sizeof(int32_t) * (size_t)r;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(partition_count,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    RT_CHECK();
  }
  const long long tiles_per_row = (b + TILE_KEYS - 1) / TILE_KEYS;
  partition_count<<<(unsigned)(nb * tiles_per_row), THREADS, smem, s>>>(
      keys, bounds, out, b, r, tiles_per_row);
  RT_CHECK();
  return 0;
}
