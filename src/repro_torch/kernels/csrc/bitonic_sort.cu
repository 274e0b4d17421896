// Row-wise lex sort of (key, val) uint32 records: the map-task sort.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py
// bitonic_sort_blocks (body _sort_block_kernel / _bitonic_network), which
// sorts each (1, B) row inside VMEM. On the main path a row is B = 2^20
// records (8 MiB), far beyond the 227 KB of shared memory a block can
// hold, so the same bitonic network runs as a few passes over the row.
//
// Bound on this card: bytes. The least traffic is one read and one write
// of 8 bytes per record: 128 MB, 0.040 ms at 3.35 TB/s for (8, 2^20). The
// design cuts the passes over device memory:
//
//   * records are packed once, as (uint64)key << 32 | val, whose unsigned
//     order is the lex (key, val) order, so a compare-exchange is one
//     64-bit compare; the first pass reads the key and val arrays, the
//     last pass writes them, and the passes between work in place on a
//     packed u64 scratch row that the wrapper allocates;
//   * bitonic_tile: one block per tile (TILE_MAX = 2^13 records: 512
//     threads of E = 16 records each, 68 KB of dynamic shared memory, two
//     blocks an SM so one block's loads overlap the other's compares)
//     runs every substage whose distance is below the tile, with the tile
//     in registers: three layouts (C, A, B below) put distances 1..8,
//     32..256 and T..tile/2 (T = threads) between two registers of one
//     thread and distance 16 between two lanes (shuffle); shared memory
//     only carries the switches between layouts;
//   * bitonic_global<R>: for distances of a tile or more, one pass runs R
//     (1..6) consecutive substages d, d/2, .., d/2^(R-1) of one window.
//     Each thread loads the 2^R records at stride d/2^(R-1) that those
//     substages touch, runs them in registers and stores once; lanes take
//     neighbouring addresses, so loads stay coalesced.
//
// The launch plan (which substages each pass runs) is computed by the
// wrapper (bitonic_sort.sort_plan) and handed over as (window, first
// distance, substage count) triples: pass 0 sorts the tiles (windows
// 2..tile), then each window w > tile takes ceil(log2(w / tile) / 6)
// fused global passes and one tile pass for its distances below the tile.
// For B = 2^20 and 2^13 tiles that is 1 + 8 + 7 = 16 passes over the row
// (a split by distance alone, one launch per global substage with
// 4096-record tiles, makes 45). A global pass runs at about the copy
// rate; a tile pass does not: its compares are 64-bit integer work, a few
// instructions per record per substage, and the tile sort alone runs 91
// substages, so the tile passes are bound by integer issue slots rather
// than bytes, and the kernel stays far above its byte bound.
//
// Direction follows the reference: a pair (i, i + d) inside stage window w
// sorts ascending iff (i & w) == 0 on the index within the row, so the
// final window (w = B) is ascending. The order is total on (key, val), so
// the output is bit-equal to any other correct sort of the row.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int E = 16;                 // records per thread in a tile pass
constexpr int WARP_SPAN = 32 * E;     // records one warp holds in registers
constexpr int TILE_MAX = 1 << 13;     // records per tile: 64 KB packed
constexpr int TILE_THREADS = TILE_MAX / E;
constexpr int GLOBAL_THREADS = 256;
constexpr int FUSE_MAX = 6;           // substages a fused global pass runs

// Order (a, b) ascending, or descending if desc: one 64-bit compare.
__device__ __forceinline__ void cx(u64& a, u64& b, bool desc) {
  const bool swap = (a > b) != desc;
  const u64 t = a;
  a = swap ? b : a;
  b = swap ? t : b;
}

__device__ __forceinline__ u64 load_rec(const uint32_t* k, const uint32_t* v,
                                        const u64* x, long long i) {
  return k ? ((u64)k[i] << 32) | v[i] : x[i];
}

__device__ __forceinline__ void store_rec(uint32_t* k, uint32_t* v, u64* x,
                                          long long i, u64 r) {
  if (k) {
    k[i] = (uint32_t)(r >> 32);
    v[i] = (uint32_t)r;
  } else {
    x[i] = r;
  }
}

// Where a tile pass keeps the tile between substages. Tile position of
// register j (0..E-1) in thread t = 32 * warp + lane (T = blockDim.x
// threads, T * E = tile):
//   C: warp * WARP_SPAN + E * lane + j — distances 1..8 pair two registers
//      of one thread, distance 16 register j of two neighbouring lanes;
//   A: warp * WARP_SPAN + 32 * j + lane — distances 32..256 pair two
//      registers of one thread;
//   B: t + T * j — distances T..tile/2 pair two registers of one thread.
// T <= WARP_SPAN, so every distance below the tile has a layout. Each
// layout gives each position to one thread, so a switch is: store own
// positions, barrier, load own positions. C and A
// hold the same WARP_SPAN records of a warp, so between them the warp's
// barrier is enough. The tile runs in registers, where the compares are
// integer instructions, and the most frequent distances (1..8 come up in
// every window) cost no shuffle.
enum Where { IN_A, IN_B, IN_C };

// Shared-memory slot of tile position p: one pad slot after every 16, so
// the 16 lanes of a half-warp hit 16 banks in every layout (C's lanes are
// E = 16 records apart) and each register's slot is base + j * stride.
__device__ __forceinline__ int slot(int p) { return p + (p >> 4); }

// The direction of a pair whose lower tile position is p: descending iff
// bit w of its row index is set. desc_tile = (tile_base & w) != 0, and
// wl = w if w < tile else 0 (then p & w == 0).
__device__ __forceinline__ bool desc_at(bool desc_tile, int wl, int p) {
  return desc_tile != ((p & wl) != 0);
}

// Registers j and j | M of a thread, for each j without bit M; bit j of
// desc is the direction of the pair whose lower register is j.
template <int M>
__device__ __forceinline__ void reg_pairs(u64 (&x)[E], unsigned desc) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j & M) continue;
    cx(x[j], x[j | M], (desc & (1u << j)) != 0);
  }
}

// Register j of this lane and of lane ^ D; bit j of keep_max says which
// of the two this lane keeps.
template <int D>
__device__ __forceinline__ void lane_pairs(u64 (&x)[E], unsigned keep_max) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x[j], D);
    x[j] = ((y > x[j]) == ((keep_max & (1u << j)) != 0)) ? y : x[j];
  }
}

// Layout C: substages at distances d, d/2, .., dlo (all <= 16).
__device__ __forceinline__ void substages_c(u64 (&x)[E], unsigned desc,
                                            int lane, int d, int dlo) {
  auto on = [&](int D) { return D <= d && D >= dlo; };
  if (on(16)) lane_pairs<1>(x, desc ^ ((lane & 1) ? 0xffffu : 0u));
  if (on(8)) reg_pairs<8>(x, desc);
  if (on(4)) reg_pairs<4>(x, desc);
  if (on(2)) reg_pairs<2>(x, desc);
  if (on(1)) reg_pairs<1>(x, desc);
}

// Layouts A and B: substages at distances d, d/2, .., dlo, each `unit`
// times a register distance (A: unit 32, B: unit T).
__device__ __forceinline__ void substages_ab(u64 (&x)[E], unsigned desc,
                                             int unit, int d, int dlo) {
  auto on = [&](int m) { return unit * m <= d && unit * m >= dlo; };
  if (on(8)) reg_pairs<8>(x, desc);
  if (on(4)) reg_pairs<4>(x, desc);
  if (on(2)) reg_pairs<2>(x, desc);
  if (on(1)) reg_pairs<1>(x, desc);
}

// One substage at distance d over a tile below WARP_SPAN records, in
// shared memory: threads loop over the pairs.
__device__ __forceinline__ void smem_substage(u64* s, int tile,
                                              bool desc_tile, int wl, int d) {
  for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
    const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
    u64 a = s[slot(i)], b = s[slot(i + d)];
    cx(a, b, desc_at(desc_tile, wl, i));
    s[slot(i)] = a;
    s[slot(i + d)] = b;
  }
  __syncthreads();
}

__device__ __forceinline__ void advance(long long& w, long long& d, int k) {
  d >>= k;
  if (d == 0) {
    w <<= 1;
    d = w >> 1;
  }
}

// n substages of the network from (w, d) on, all at distances < tile, on
// each tile of each row. The source is (kin, vin) if kin is set, else xin;
// the destination (kout, vout) if kout is set, else xout. A tile of at
// least WARP_SPAN records runs with blockDim = tile / E in registers; a
// smaller one (a short row) runs every substage in shared memory.
__global__ void __launch_bounds__(TILE_THREADS, 2)
bitonic_tile(const uint32_t* kin, const uint32_t* vin, const u64* xin,
             uint32_t* kout, uint32_t* vout, u64* xout, long long b,
             int tile, long long w, long long d, int n) {
  extern __shared__ u64 s[];
  const long long tiles_per_row = b / tile;
  const long long tile_base = (blockIdx.x % tiles_per_row) * (long long)tile;
  const long long off = (blockIdx.x / tiles_per_row) * b + tile_base;
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  if (tile < WARP_SPAN) {
    for (int i = t; i < tile; i += T) s[slot(i)] = load_rec(kin, vin, xin, off + i);
    __syncthreads();
    for (; n > 0; --n, advance(w, d, 1))
      smem_substage(s, tile, (tile_base & w) != 0, w < tile ? (int)w : 0,
                    (int)d);
    for (int i = t; i < tile; i += T) store_rec(kout, vout, xout, off + i, s[slot(i)]);
    return;
  }
  const int wbase = (t >> 5) * WARP_SPAN;
  // tile position of register j, and its shared-memory slot: base + j * step
  auto pos = [&](Where lay, int j) {
    return lay == IN_A ? wbase + 32 * j + lane
                       : (lay == IN_C ? wbase + E * lane + j : t + T * j);
  };
  auto slot_of = [&](Where lay, int j) {
    return lay == IN_A ? slot(wbase + lane) + 34 * j
                       : (lay == IN_C ? slot(wbase + E * lane) + j
                                      : slot(t) + (T + T / 16) * j);
  };
  // T <= WARP_SPAN: distances WARP_SPAN and up are all >= T
  auto layout_for = [&](long long dd) {
    return dd < 32 ? IN_C : (dd < WARP_SPAN ? IN_A : IN_B);
  };
  u64 x[E];
  // device memory <-> registers in A or B (coalesced)
  Where at = n > 0 && layout_for(d) != IN_C ? layout_for(d) : IN_A;
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = load_rec(kin, vin, xin, off + pos(at, j));
  auto switch_to = [&](Where want) {  // own positions out, barrier, in
    if (want == at) return;
#pragma unroll
    for (int j = 0; j < E; ++j) s[slot_of(at, j)] = x[j];
    if (want != IN_B && at != IN_B)
      __syncwarp();
    else
      __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = s[slot_of(want, j)];
    at = want;
  };
  while (n > 0) {
    switch_to(layout_for(d));
    const bool desc_tile = (tile_base & w) != 0;
    const int wl = w < tile ? (int)w : 0;
    // this window's substages from d down to the layout's last distance
    const long long stop = at == IN_C ? 1 : (at == IN_A ? 32 : T);
    int k = 0;
    for (long long dd = d; dd >= stop && k < n; dd >>= 1) ++k;
    const int dlo = (int)(d >> (k - 1));
    unsigned desc = 0;  // bit j: the direction of register j's pairs
#pragma unroll
    for (int j = 0; j < E; ++j)
      desc |= (unsigned)desc_at(desc_tile, wl, pos(at, j)) << j;
    if (at == IN_C)
      substages_c(x, desc, lane, (int)d, dlo);
    else
      substages_ab(x, desc, at == IN_A ? 32 : T, (int)d, dlo);
    n -= k;
    advance(w, d, k);
  }
  if (at == IN_C) switch_to(IN_A);  // C is not coalesced in device memory
#pragma unroll
  for (int j = 0; j < E; ++j) store_rec(kout, vout, xout, off + pos(at, j), x[j]);
}

// R substages d, d/2, .., d/2^(R-1) (= s = 2^log_s) of window w, in place
// on packed rows of b = 2^(log_gpr + R) records: group g of a row holds
// the 2^R records base + k * s, base = (g / s) * 2d + g % s.
template <int R>
__global__ void __launch_bounds__(GLOBAL_THREADS)
bitonic_global(u64* x, long long groups, int log_gpr, int log_s, long long w) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long gr = g & ((1LL << log_gpr) - 1);
  const long long s = 1LL << log_s;
  const long long base = ((gr >> log_s) << (log_s + R)) | (gr & (s - 1));
  const bool desc = (base & w) != 0;  // w >= 2d: one direction per group
  u64* p = x + ((g >> log_gpr) << (log_gpr + R)) + base;
  u64 r[1 << R];
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) r[k] = p[k * s];
#pragma unroll
  for (int m = R - 1; m >= 0; --m) {
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & (1 << m)) continue;
      cx(r[k], r[k | (1 << m)], desc);
    }
  }
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) p[k * s] = r[k];
}

template <int R>
int launch_global(u64* x, long long nb, long long b, long long w, long long d,
                  cudaStream_t st) {
  const long long groups = nb * (b >> R);
  const int log_b = 63 - __builtin_clzll(b);
  const int log_s = 63 - __builtin_clzll(d) - (R - 1);
  const unsigned blocks =
      (unsigned)((groups + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  bitonic_global<R><<<blocks, GLOBAL_THREADS, 0, st>>>(x, groups, log_b - R,
                                                       log_s, w);
  RT_CHECK();
  return 0;
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// A tile's shared memory: its records and one pad slot per 16 (slot()).
size_t smem_bytes(long long tile) {
  return (size_t)(tile + tile / 16 + 1) * sizeof(u64);
}

// Whether pass i of the plan is one the kernels run: a fused global pass
// (not first or last) of 1..FUSE_MAX substages at distances >= tile inside
// one window, or a tile pass whose substages all lie below the tile.
bool valid_pass(const long long* p, int i, int npasses, long long b,
                long long tile) {
  const long long w = p[0], d = p[1], n = p[2];
  if (!pow2(w) || !pow2(d) || d >= w || n < 0) return false;
  if (i > 0 && d >= tile)
    return i < npasses - 1 && w <= b && n >= 1 && n <= FUSE_MAX &&
           (d >> (n - 1)) >= tile;
  for (long long ww = w, dd = d, k = 0; k < n; ++k) {
    if (dd >= tile) return false;
    dd >>= 1;
    if (dd == 0) dd = (ww <<= 1) >> 1;
  }
  return true;
}

}  // namespace

// Sort each row of (nb, b) (kin, vin) into (kout, vout); b a power of two.
// plan holds npasses (window, first distance, substage count) triples in
// network order (bitonic_sort.sort_plan): pass 0 is the tile sort, a later
// pass with distance >= tile is a fused global pass, any other a tile pass.
// scratch is a packed (nb, b) u64 buffer, unused (may be null) for a
// one-pass plan. A plan the kernels cannot run launches nothing.
RT_API int rt_bitonic_sort(const uint32_t* kin, const uint32_t* vin,
                           uint32_t* kout, uint32_t* vout, u64* scratch,
                           long long nb, long long b, long long tile,
                           const long long* plan, int npasses, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || b <= 0) return 0;
  if (!pow2(b) || !pow2(tile) || tile > b || tile > TILE_MAX || npasses < 1 ||
      (npasses > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < npasses; ++i)
    if (!valid_pass(plan + 3 * i, i, npasses, b, tile))
      return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(bitonic_tile,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes(TILE_MAX));
  RT_CHECK();
  const unsigned tiles = (unsigned)(nb * (b / tile));
  const int threads = tile >= WARP_SPAN ? (int)tile / E
                                        : (tile >= 2 ? (int)tile / 2 : 1);
  for (int i = 0; i < npasses; ++i) {
    const long long w = plan[3 * i], d = plan[3 * i + 1];
    const int n = (int)plan[3 * i + 2];
    const bool first = i == 0, last = i == npasses - 1;
    if (!first && d >= tile) {  // fused global pass, in place on scratch
      int rc;
      switch (n) {
        case 1: rc = launch_global<1>(scratch, nb, b, w, d, st); break;
        case 2: rc = launch_global<2>(scratch, nb, b, w, d, st); break;
        case 3: rc = launch_global<3>(scratch, nb, b, w, d, st); break;
        case 4: rc = launch_global<4>(scratch, nb, b, w, d, st); break;
        case 5: rc = launch_global<5>(scratch, nb, b, w, d, st); break;
        default: rc = launch_global<6>(scratch, nb, b, w, d, st); break;
      }
      if (rc) return rc;
      continue;
    }
    bitonic_tile<<<tiles, threads, smem_bytes(tile), st>>>(
        first ? kin : nullptr, first ? vin : nullptr, first ? nullptr : scratch,
        last ? kout : nullptr, last ? vout : nullptr, last ? nullptr : scratch,
        b, (int)tile, w, d, n);
    RT_CHECK();
  }
  return 0;
}
