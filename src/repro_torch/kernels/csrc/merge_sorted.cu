// Row-wise merge of two lex-sorted (key, val) uint32 runs:
// (n, L) + (n, L) -> (n, 2L).
//
// Replaces the TPU kernel src/repro/kernels/merge_sorted.py
// merge_sorted_pairs (body _merge_pair_kernel / _merge_network), which
// concatenates a with reversed b and runs one bitonic merge pass in VMEM.
// On the main path a run is up to L = 2^21 records (the stage-2 merge),
// so instead of a network this is a merge path, tiled:
//
//   * a block owns TILE consecutive outputs of a row. Two of its warps
//     find where the tile's first and last diagonals cross a and b (the
//     co-ranks, ties to a), 32 lanes testing 32 splits a step: ~log32 L
//     dependent reads instead of log2 L;
//   * the block copies the tile's two input windows into shared memory,
//     packed once as u64 (key << 32 | val) so a compare is one compare
//     (16-byte loads where the rows allow, else 4-byte ones; coalesced
//     either way);
//   * each thread searches its ITEMS-output sub-diagonal in shared memory
//     and merges its ITEMS records into registers;
//   * the block writes keys and values back through shared memory, so
//     the stores are coalesced (16 bytes a thread where aligned).
//
// Records equal on (key, val) are bit-identical, so the tie rule cannot
// change the output: it equals the reference's network output on sorted
// rows. Rows padded with lex-max records are merged like any other.
//
// Bound on this card: bytes — each input record read once and each
// output written once (32 bytes per output pair of records). On top of
// them come the co-rank probes: 2 warps x 32 lanes x ~5 steps a tile of
// 2048 outputs, scattered reads that the neighbouring tiles share in L2.
#include "common.cuh"

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;                  // outputs per thread
constexpr int TILE = THREADS * ITEMS;     // outputs per block
constexpr int LANES = 32;

__device__ __forceinline__ u64 pack(uint32_t k, uint32_t v) {
  return (u64)k << 32 | v;
}

// Co-rank of diagonal d: how many of a row's first d outputs come from a,
// i.e. the first i with a[i] > b[d-1-i], or the top of the range. Called
// by a whole warp; each step the lanes test 32 splits of the open range
// [lo, hi) and keep the piece where the test turns true.
__device__ long long corank(const uint32_t* ak, const uint32_t* av,
                            const uint32_t* bk, const uint32_t* bv,
                            long long L, long long d, int lane) {
  long long lo = d > L ? d - L : 0, hi = d < L ? d : L;
  while (lo < hi) {
    const long long n = hi - lo;
    const long long q = lo + (lane + 1) * n / LANES - 1;  // >= lo - 1
    bool p = false;
    if (q >= lo) {
      const long long j = d - 1 - q;
      p = pack(ak[q], av[q]) > pack(bk[j], bv[j]);
    }
    const unsigned hit = __ballot_sync(0xffffffffu, p);
    if (!hit) return hi;  // lane 31 tested hi - 1: nothing in range is true
    const int f = __ffs(hit) - 1;
    // Lanes below f tested false (or lay below lo); lane f tested true.
    hi = lo + (f + 1) * n / LANES - 1;
    lo += f * n / LANES;
  }
  return lo;
}

// dst[e - lo] = pack(k[e], v[e]) for e in [lo, hi).
template <bool VEC>
__device__ __forceinline__ void stage(const uint32_t* k, const uint32_t* v,
                                      long long lo, long long hi, u64* dst) {
  if (VEC) {  // whole 16-byte chunks, keeping the records inside [lo, hi)
    for (long long c = (lo >> 2) + threadIdx.x; c < (hi + 3) >> 2;
         c += THREADS) {
      const uint4 kk = reinterpret_cast<const uint4*>(k)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(v)[c];
      const uint32_t ks[4] = {kk.x, kk.y, kk.z, kk.w};
      const uint32_t vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long e = 4 * c + q;
        if (e >= lo && e < hi) dst[e - lo] = pack(ks[q], vs[q]);
      }
    }
  } else {
    for (long long e = lo + threadIdx.x; e < hi; e += THREADS)
      dst[e - lo] = pack(k[e], v[e]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
merge_tiles(const uint32_t* ak, const uint32_t* av, const uint32_t* bk,
            const uint32_t* bv, uint32_t* ok, uint32_t* ov, long long L,
            long long tiles_per_row, int tile) {
  __shared__ u64 s[TILE];  // the inputs, then keys and vals of the outputs
  __shared__ long long cr[2];
  const long long row = blockIdx.x / tiles_per_row;
  const long long d0 = blockIdx.x % tiles_per_row * tile;
  const uint32_t *a_k = ak + row * L, *a_v = av + row * L;
  const uint32_t *b_k = bk + row * L, *b_v = bv + row * L;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  if (warp < 2) {
    const long long c = corank(a_k, a_v, b_k, b_v, L, d0 + warp * tile, lane);
    if (lane == 0) cr[warp] = c;
  }
  __syncthreads();
  const long long i0 = cr[0], j0 = d0 - i0;
  const int na = (int)(cr[1] - i0), nb = tile - na;
  stage<VEC>(a_k, a_v, i0, i0 + na, s);
  stage<VEC>(b_k, b_v, j0, j0 + nb, s + na);
  __syncthreads();

  // This thread's outputs [dd, dd + ITEMS) of the tile.
  const int dd = min((int)threadIdx.x * ITEMS, tile);
  int lo = max(0, dd - nb), hi = min(dd, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] > s[na + dd - 1 - mid]) hi = mid;
    else lo = mid + 1;
  }
  int i = lo, j = dd - lo;
  u64 x = i < na ? s[i] : 0, y = j < nb ? s[na + j] : 0;
  u64 out[ITEMS];
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    if (j >= nb || (i < na && x <= y)) {
      out[m] = x;
      x = ++i < na ? s[i] : 0;
    } else {
      out[m] = y;
      y = ++j < nb ? s[na + j] : 0;
    }
  }
  __syncthreads();
  uint32_t* sk = reinterpret_cast<uint32_t*>(s);
  uint32_t* sv = sk + TILE;
  uint32_t k8[ITEMS], v8[ITEMS];
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    k8[m] = (uint32_t)(out[m] >> 32);
    v8[m] = (uint32_t)out[m];
  }
  if (dd + ITEMS <= tile) {  // 16-byte stores: a quarter of the wavefronts
#pragma unroll
    for (int m = 0; m < ITEMS; m += 4) {
      reinterpret_cast<uint4*>(sk + dd + m)[0] =
          make_uint4(k8[m], k8[m + 1], k8[m + 2], k8[m + 3]);
      reinterpret_cast<uint4*>(sv + dd + m)[0] =
          make_uint4(v8[m], v8[m + 1], v8[m + 2], v8[m + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < ITEMS; ++m)
      if (dd + m < tile) {
        sk[dd + m] = k8[m];
        sv[dd + m] = v8[m];
      }
  }
  __syncthreads();
  uint32_t *o_k = ok + row * 2 * L + d0, *o_v = ov + row * 2 * L + d0;
  if (VEC) {
    for (int c = threadIdx.x; c < tile / 4; c += THREADS) {
      reinterpret_cast<uint4*>(o_k)[c] = reinterpret_cast<const uint4*>(sk)[c];
      reinterpret_cast<uint4*>(o_v)[c] = reinterpret_cast<const uint4*>(sv)[c];
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += THREADS) {
      o_k[e] = sk[e];
      o_v[e] = sv[e];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// `tile` is the wrapper's min(2L, TILE): a wrapper built for another tile
// size gets an error, not a wrong merge.
RT_API int rt_merge_pairs(const uint32_t* ak, const uint32_t* av,
                          const uint32_t* bk, const uint32_t* bv,
                          uint32_t* ok, uint32_t* ov, long long n, long long L,
                          long long tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0) return 0;
  if ((L & (L - 1)) || tile != (2 * L < TILE ? 2 * L : TILE))
    return (int)cudaErrorInvalidValue;
  const long long tiles = 2 * L / tile;
  const unsigned blocks = (unsigned)(n * tiles);
  // 16-byte chunks of a row start on 16-byte boundaries when L % 4 == 0.
  if (L % 4 == 0 && aligned16(ak) && aligned16(av) && aligned16(bk) &&
      aligned16(bv) && aligned16(ok) && aligned16(ov))
    merge_tiles<true><<<blocks, THREADS, 0, s>>>(ak, av, bk, bv, ok, ov, L,
                                                 tiles, (int)tile);
  else
    merge_tiles<false><<<blocks, THREADS, 0, s>>>(ak, av, bk, bv, ok, ov, L,
                                                  tiles, (int)tile);
  RT_CHECK();
  return 0;
}
