// The key-tail stage of the whole 10-byte key (core/keytail.order_key_tails):
// in each held worker's valid prefix, which the merge left in (key word, id)
// order, every run of equal key words is ordered by (key bytes 4-7, key
// bytes 8-9, position), and its ids and payload rows are moved into that
// order in place. Position stands in for the id, which the merge already
// ordered. Key bytes 4-9 are payload word 0 and the high half of word 1,
// compared as unsigned numbers.
//
// Replaces no TPU kernel: the reference has no key-tail stage (it sorts a
// 4-byte key). The port's plain version is a composition of aten ops that
// flags the neighbouring pairs, compacts them into a buffer of each pair's
// first record and the second where its run ends, orders the buffer with
// two stable library sorts and moves ids and rows by index_select and
// index_copy_: about 40 passes, over a buffer 1.8 times the tied records.
//
// Bound on this card: bytes. Finding the runs reads each valid key word once
// (4 B a record); ordering a run reads each tied record's key bytes 4-9 (8
// B), and a record whose place changes has its id and row read and written
// once (its key bytes within the row): 4 V + 8 T + 8 pw X bytes for V
// valid and T tied records, X of them moved (at most 8.7 GB, 2.6 ms at
// 3.35 TB/s, where two thirds of 2^26 records are tied). The finding warp
// leaves a record of a short run that is in place untouched; the longer
// classes copy a whole run through their stage. The design, by the length
// L of a run, which the kernels observe:
//
//   * key_tail_find: one warp a tile of 32 positions of one worker (the words
//     of GROUP tiles loaded at once) marks where the word changes (a ballot
//     each half of the tile and the next 32 words) and so finds each run
//     that starts in the tile. A run of L <= 32 ends inside those 64 words:
//     where every such run of the tile is at most RANK_MAX long (rare ties)
//     each record counts the keys below it in its run over a few shuffles;
//     else the warp sorts the 64 places in registers (a bitonic network over
//     shuffles) on (run start, key bytes 4-9, place), which leaves every
//     place outside such a run where it is. The ids move by shuffles, the
//     rows that move through the warp's share of shared memory. A longer
//     run is measured by a galloping search of the sorted words and listed
//     with warp-aggregated atomics; the warp adds its runs' records and pairs
//     to the stage's counts once.
//   * key_tail_order, mid class (33 <= L <= MID_MAX): a block of 256 threads
//     a run, several on an SM; each record's rank is the count of the run's
//     keys (key bytes 4-9 << 16 | place) below it, read from shared memory,
//     with no barrier between. The run's rows and ids are then copied as
//     they lie into shared memory (16-byte words) and written back in order,
//     each word gathered from there: both passes over device memory are
//     contiguous, the random reads fall on shared memory.
//   * key_tail_order, large class (L > MID_MAX): a block of 1024 threads and
//     all of the SM's shared memory a run, in the order they were listed
//     (lists by length, longest first, were 0.3 ms slower on an H100 with
//     two thirds of 2^26 records tied); the keys
//     sorted by a bitonic network held in registers (L / 1024 keys a thread,
//     1 to 16: strides within a warp by shuffles, longer ones through shared
//     memory), then the move as above, staged in shared memory where the
//     rows fit (about 2,300 at pw = 23) and in global scratch past that. A
//     run longer than SORT_CAP = 16,384 (a hot key) sorts chunks of SORT_CAP
//     and merges them pass by pass by rank (a binary search in the sibling
//     chunk) in scratch: correct up to a whole worker, its speed there not
//     the point.
//
// The position within a run takes 16 bits of a key, so keys stay unique for
// runs of up to 65,536 records, above SORT_CAP. Runs are independent and a
// run never straddles two workers, so the lists' order does not matter.
// Under a fixed capacity of pairs (the workers' equal ranges) the lists and
// scratch are sized from it (rt_key_tail_sizes) with no host wait, and
// `overflow` is set past it. A run that a list or the scratch cannot hold
// is left as it is and sets `overflow` too, so that sizes that fall short
// of the runs fail loudly. The stage also counts the records whose place
// changes (`moved`, the bytes' least count for key_tail_roofline).
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TILE = 32;            // positions a warp owns
constexpr int WINDOW = 2 * TILE;    // positions it reads
constexpr int GROUP = 8;            // tiles whose words a warp loads at once
constexpr int FIND_THREADS = 256;
constexpr int FIND_WARPS = FIND_THREADS / 32;
constexpr int FIND_COLS = 12;       // row words a short run moves a pass
constexpr int RANK_MAX = 8;         // longest runs a tile ranks over shuffles
constexpr int MID_THREADS = 256;
constexpr int MID_MAX = 512;        // longest run of the mid class
constexpr int MID_SMEM = 25 * 1024;  // at least (more where pw needs it)
constexpr int LARGE_THREADS = 1024;
constexpr int LARGE_SMEM = 232448;  // at most (the card's limit is lower)
constexpr int E = 16;               // keys a thread of the large class holds
constexpr int SORT_CAP = LARGE_THREADS * E;  // longest run sorted whole
constexpr int STAGE_SLACK = 3;      // words a stage may start past its base
constexpr int HUGE_WORDS = 6;  // merge scratch words a record past SORT_CAP

// The stage's int64 counts on the card (`state`).
enum : int {
  TIED,          // records in runs
  PAIRS,         // neighbouring pairs of equal words
  SCRATCH,       // scratch words the large class needs
  MOVED,         // records whose place in their run changes
  COUNT_MID,     // runs appended to the mid list
  NEXT_MID,      // the next list entry a block takes
  NEXT_LARGE,
  CURSOR,        // scratch words handed out
  COUNT_LARGE,   // runs appended to the large list
  STATE_LEN
};

typedef unsigned long long u64;

struct Stage {
  const uint32_t* keys;  // (wl, m)
  uint32_t* ids;         // (wl, m)
  uint32_t* rows;        // (wl, m, pw)
  const int32_t* valid;  // (wl,)
  u64* state;            // (STATE_LEN,)
  longlong2* mid;        // (start, length) of runs of the mid class
  longlong2* large;      // of the large class
  long long wl, m, cap_mid, cap_large;
  int pw;
  int smem_rows;  // the longest run of the large class staged in shared memory
};

// Key bytes 4-9 of a row: payload word 0, then the high half of word 1.
__device__ __forceinline__ u64 tail48(const uint32_t* row) {
  return ((u64)row[0] << 16) | (row[1] >> 16);
}

// The first position in (at, v) whose word differs from keys[at] == key, or
// v: a galloping search of the sorted words, then a binary one.
__device__ long long run_end(const uint32_t* __restrict__ keys, long long at,
                             long long v, uint32_t key) {
  long long lo = at, hi, step = WINDOW;
  for (;;) {
    hi = lo + step;
    if (hi >= v) {
      hi = v;
      break;
    }
    if (__ldg(keys + hi) != key) break;
    lo = hi;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) == key)
      lo = mid;
    else
      hi = mid;
  }
  return hi;
}

// Appends `item` for each lane where `mine`, one atomic a warp; an entry
// past `cap` is counted and dropped (the mid class's launch then sets
// `overflow`).
__device__ __forceinline__ void append(bool mine, longlong2 item, u64* count,
                                       longlong2* list, long long cap,
                                       int lane) {
  const unsigned mask = __ballot_sync(FULL, mine);
  if (!mask) return;
  const int leader = __ffs(mask) - 1;
  u64 base = 0;
  if (lane == leader) base = atomicAdd(count, (u64)__popc(mask));
  base = __shfl_sync(FULL, base, leader);
  if (mine) {
    const long long at = (long long)base + __popc(mask & ((1u << lane) - 1));
    if (at < cap) list[at] = item;
  }
}

// Scratch words a run of the large class takes: past SORT_CAP the merge's
// keys and places, then, where its rows do not fit in shared memory, the
// stage of its rows and ids; multiples of 4 words, so that every stage
// starts 16-byte aligned.
__host__ __device__ __forceinline__ long long sort_words(long long len) {
  return len > SORT_CAP ? (HUGE_WORDS * len + 3) & ~3LL : 0;
}
__host__ __device__ __forceinline__ long long scratch_words(long long len,
                                                            int pw,
                                                            int smem_rows) {
  return sort_words(len) +
         (len > smem_rows ? (STAGE_SLACK + len * (pw + 1) + 3) & ~3LL : 0);
}

// One tile of 32 positions at `base` of worker w, whose valid prefix is
// v: its window's words k0 (position base + lane) and k1 (base + 32 +
// lane), and `before`, the word at base - 1 (where base > 0). Finds the
// runs that start in the tile, orders those of up to 32 records, lists
// the longer ones.
__device__ __forceinline__ void find_tile(const Stage& a, long long w,
                                          long long v, long long base,
                                          uint32_t k0, uint32_t k1,
                                          uint32_t before, int lane,
                                          uint32_t* stage,
                                          unsigned short* moves, u64& tied,
                                          u64& pairs, u64& changed) {
  const int pw = a.pw;
  const uint32_t* keys = a.keys + w * a.m;
  const long long p0 = base + lane, p1 = p0 + TILE;
  const bool in0 = p0 < v, in1 = p1 < v;
  // each window position against the one before it
  uint32_t q0 = __shfl_up_sync(FULL, k0, 1);
  uint32_t q1 = __shfl_up_sync(FULL, k1, 1);
  const uint32_t last0 = __shfl_sync(FULL, k0, 31);
  if (lane == 0) {
    q0 = before;
    q1 = last0;
  }
  const bool same0 = in0 && p0 > 0 && k0 == q0;
  const bool same1 = in1 && k1 == q1;
  // bit i: window position i starts a run of equal words (or is past v)
  const u64 brk = (u64)__ballot_sync(FULL, !same0) |
                  ((u64)__ballot_sync(FULL, !same1) << 32);
  const unsigned heads = (unsigned)(brk & ~(brk >> 1));  // and i + 1 is in it
  if (!heads) return;
  const bool head = (heads >> lane) & 1u;
  long long len = 0;
  if (head) {
    const u64 rest = brk >> (lane + 1);
    len = rest ? __ffsll((long long)rest)
               : run_end(keys, base + WINDOW - 1, v, k0) - p0;
    tied += len;
    pairs += len - 1;
  }
  const longlong2 item = make_longlong2(w * a.m + p0, len);
  append(head && len > TILE && len <= MID_MAX, item, a.state + COUNT_MID,
         a.mid, a.cap_mid, lane);
  append(head && len > MID_MAX, item, a.state + COUNT_LARGE, a.large,
         a.cap_large, lane);
  if (head && len > MID_MAX)
    atomicAdd(a.state + SCRATCH, (u64)scratch_words(len, pw, a.smem_rows));
  const unsigned short_heads = __ballot_sync(FULL, head && len <= TILE);
  if (!short_heads) return;
  // the runs of <= 32 records that start in the tile, sorted in one pass of
  // 64 keys (run start, key bytes 4-9, position); every other window
  // position keys (itself, position) and stays
  uint32_t* rowbase = a.rows + (w * a.m + base) * pw;
  uint32_t* idbase = a.ids + w * a.m + base;
  u64 key[2];
  uint32_t id[2];
  int start[2], end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + h * TILE;
    const u64 upto = brk & ((2ull << i) - 1);
    const u64 above = brk & ~((2ull << i) - 1);
    const int s = upto ? 63 - __clzll((long long)upto) : 63;
    const bool part = s < TILE && ((short_heads >> s) & 1u);
    start[h] = part ? s : i;
    end[h] = part ? (above ? __ffsll((long long)above) - 1 : WINDOW) : i + 1;
    key[h] = part ? ((u64)s << 54) |
                        (tail48(rowbase + (long long)i * pw) << 6) | (u64)i
                  : ((u64)i << 54) | (u64)i;
    id[h] = part ? idbase[i] : 0u;
  }
  // (src, dst) of each window position: where its record comes from, or
  // where it goes
  int src[2], dst[2];
  const int longest = (int)__reduce_max_sync(
      FULL, head && len <= TILE ? (unsigned)len : 0u);
  if (longest <= RANK_MAX) {
    // short runs only (ties are rare): each record counts the keys below
    // it in its run, its neighbours up to longest - 1 places away
    int below[2] = {0, 0};
    for (int d = 1; d < longest; ++d) {
      const u64 up0 = __shfl_sync(FULL, key[0], (lane + d) & 31);
      const u64 up1 = __shfl_sync(FULL, key[1], (lane + d) & 31);
      const u64 dn0 = __shfl_sync(FULL, key[0], (lane - d) & 31);
      const u64 dn1 = __shfl_sync(FULL, key[1], (lane - d) & 31);
      const bool wrap_up = lane + d >= TILE, wrap_dn = lane < d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + h * TILE;
        // place i + d lies in the other half past a wrap; past the window
        // it is no record's (end[h] <= WINDOW excludes it)
        const u64 upper = h ? up1 : (wrap_up ? up1 : up0);
        const u64 lower = h ? (wrap_dn ? dn0 : dn1) : dn0;
        below[h] += (i + d < end[h] && upper < key[h]) +
                    (i - d >= start[h] && lower < key[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + h * TILE;
      src[h] = i;
      dst[h] = start[h] + below[h];
      if (dst[h] != i) idbase[dst[h]] = id[h];
    }
  } else {
#pragma unroll
    for (int k = 2; k <= WINDOW; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == TILE) {  // k = 64: positions lane and lane + 32
          const u64 lo = key[0] < key[1] ? key[0] : key[1];
          key[1] = key[0] < key[1] ? key[1] : key[0];
          key[0] = lo;
          continue;
        }
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64 other = __shfl_xor_sync(FULL, key[h], j);
          const bool up = ((lane + h * TILE) & k) == 0;
          const bool keep_min = lower == up;
          key[h] = keep_min ? (key[h] < other ? key[h] : other)
                            : (key[h] < other ? other : key[h]);
        }
      }
    }
    // position r takes the record from window position key & 63
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dst[h] = lane + h * TILE;
      src[h] = (int)(key[h] & 63);
      const uint32_t lo = __shfl_sync(FULL, id[0], src[h] & 31);
      const uint32_t hi = __shfl_sync(FULL, id[1], src[h] & 31);
      if (src[h] != dst[h]) idbase[dst[h]] = src[h] < TILE ? lo : hi;
    }
  }
  bool moved[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) moved[h] = src[h] != dst[h];
  const unsigned m0 = __ballot_sync(FULL, moved[0]);
  const unsigned m1 = __ballot_sync(FULL, moved[1]);
  const unsigned lt = (1u << lane) - 1;
  if (moved[0])
    moves[__popc(m0 & lt)] = (unsigned short)((src[0] << 8) | dst[0]);
  if (moved[1])
    moves[__popc(m0) + __popc(m1 & lt)] =
        (unsigned short)((src[1] << 8) | dst[1]);
  __syncwarp();
  const int count = __popc(m0) + __popc(m1);
  if (lane == 0) changed += count;
  for (int k0 = 0; k0 < pw; k0 += FIND_COLS) {
    const int cols = pw - k0 < FIND_COLS ? pw - k0 : FIND_COLS;
    const int total = count * cols;
#pragma unroll 4
    for (int t = lane; t < total; t += 32) {
      const int j = t / cols, c = t - j * cols;
      stage[t] = rowbase[(long long)(moves[j] >> 8) * pw + k0 + c];
    }
    __syncwarp();
#pragma unroll 4
    for (int t = lane; t < total; t += 32) {
      const int j = t / cols, c = t - j * cols;
      rowbase[(long long)(moves[j] & 0xFF) * pw + k0 + c] = stage[t];
    }
    __syncwarp();
  }
}

// One warp a group of GROUP tiles of one worker: their words loaded at
// once, then each tile in turn (find_tile).
__global__ void __launch_bounds__(FIND_THREADS, 4) key_tail_find(Stage a) {
  extern __shared__ uint32_t find_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* stage = find_smem + warp * (WINDOW * FIND_COLS);
  unsigned short* moves =
      reinterpret_cast<unsigned short*>(find_smem +
                                        FIND_WARPS * WINDOW * FIND_COLS) +
      warp * WINDOW;
  constexpr int SPAN = GROUP * TILE;
  const long long per_worker = (a.m + SPAN - 1) / SPAN;
  const long long groups = a.wl * per_worker;
  const long long stride = (long long)gridDim.x * FIND_WARPS;
  u64 tied = 0, pairs = 0, moved = 0;
  for (long long g0 = (long long)blockIdx.x * FIND_WARPS + warp; g0 < groups;
       g0 += stride) {
    const long long w = g0 / per_worker;
    const long long base = (g0 - w * per_worker) * SPAN;
    long long v = __ldg(a.valid + w);
    v = v < 0 ? 0 : (v > a.m ? a.m : v);
    if (base + 1 >= v) continue;  // no pair starts here (warp-uniform)
    const uint32_t* keys = a.keys + w * a.m;
    uint32_t kk[GROUP + 1];
#pragma unroll
    for (int j = 0; j <= GROUP; ++j) {
      const long long p = base + lane + j * TILE;
      kk[j] = p < v ? __ldg(keys + p) : 0u;
    }
    uint32_t before = base > 0 ? __ldg(keys + base - 1) : 0u;
    // the tiles in turn, the window's words moved down a register each
#pragma unroll 1
    for (int g = 0; g < GROUP; ++g) {
      const long long tb = base + g * TILE;
      if (tb + 1 >= v) break;
      find_tile(a, w, v, tb, kk[0], kk[1], before, lane, stage, moves, tied,
                pairs, moved);
      before = __shfl_sync(FULL, kk[0], 31);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) kk[j] = kk[j + 1];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tied += __shfl_down_sync(FULL, tied, off);
    pairs += __shfl_down_sync(FULL, pairs, off);
  }
  if (lane == 0 && tied) {
    atomicAdd(a.state + TIED, tied);
    atomicAdd(a.state + PAIRS, pairs);
    if (moved) atomicAdd(a.state + MOVED, moved);
  }
}

// One step of the large class's bitonic network inside each thread's EE
// registers: stride J, places first + r (k the size of the sequences
// being merged, which sets the direction).
template <int EE, int J>
__device__ __forceinline__ void reg_step(u64 (&v)[EE], int first, int k) {
#pragma unroll
  for (int r = 0; r < EE; ++r) {
    if (r & J) continue;
    const bool up = ((first + r) & k) == 0;
    const u64 x = v[r], y = v[r + J];
    const bool swap = (x > y) == up;
    v[r] = swap ? y : x;
    v[r + J] = swap ? x : y;
  }
}

// reg_sort's network with EE keys a thread over `big` places (a power of
// two, at least 32 * EE): strides below EE in registers, strides up to
// 32 * EE over shuffles, the longer ones through shared memory, between
// two barriers a run of such strides. Warps whose places all lie past
// `big` only keep the barriers.
template <int THREADS, int EE>
__device__ void reg_sort_e(u64* keys, int n, int big) {
  const int lane = threadIdx.x & 31, first = threadIdx.x * EE;
  const bool active = first < big;
  u64 v[EE];
#pragma unroll
  for (int r = 0; r < EE; ++r) v[r] = first + r < n ? keys[first + r] : ~0ull;
  for (int k = 2; k <= big; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * EE) {
      if (active) {
#pragma unroll
        for (int r = 0; r < EE; ++r) keys[first + r] = v[r];
      }
      __syncthreads();
      for (; j >= 32 * EE; j >>= 1) {
        const int bit = __ffs(j) - 1;
        for (int c = threadIdx.x; c < big / 2; c += THREADS) {
          const int i = ((c >> bit) << (bit + 1)) | (c & (j - 1));
          const u64 x = keys[i], y = keys[i + j];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[i + j] = x;
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < EE; ++r) v[r] = keys[first + r];
      }
    }
    if (!active) continue;  // whole warps: their places are all past big
    for (; j >= EE; j >>= 1) {  // k > EE here: the direction is the thread's
      const int lj = j / EE;
      const bool keep_min = ((lane & lj) == 0) == ((first & k) == 0);
#pragma unroll
      for (int r = 0; r < EE; ++r) {
        const u64 o = __shfl_xor_sync(FULL, v[r], lj);
        v[r] = keep_min ? (v[r] < o ? v[r] : o) : (v[r] < o ? o : v[r]);
      }
    }
    for (; j > 0; j >>= 1) {
      if constexpr (EE > 8) {
        if (j == 8) {
          reg_step<EE, 8>(v, first, k);
          continue;
        }
      }
      if constexpr (EE > 4) {
        if (j == 4) {
          reg_step<EE, 4>(v, first, k);
          continue;
        }
      }
      if constexpr (EE > 2) {
        if (j == 2) {
          reg_step<EE, 2>(v, first, k);
          continue;
        }
      }
      if constexpr (EE > 1) reg_step<EE, 1>(v, first, k);
    }
  }
  __syncthreads();  // every thread has read its places before they change
  if (active) {
#pragma unroll
    for (int r = 0; r < EE; ++r)
      if (first + r < n) keys[first + r] = v[r];
  }
  __syncthreads();
}

// Sorts keys[0, n) (n <= THREADS * E) ascending in place: a bitonic network
// over the next power of two >= n, at least 32, the places past n holding
// +inf (~0, above any key of a run of up to 65,536 records), with
// big / THREADS keys a thread (1 to E), so that every warp works once the
// run is long enough. keys must have room for that power of two; the
// caller synchronises before.
template <int THREADS>
__device__ void reg_sort(u64* keys, int n) {
  int big = 32;
  while (big < n) big <<= 1;
  switch (big / THREADS) {
    case 0:
    case 1: reg_sort_e<THREADS, 1>(keys, n, big); break;
    case 2: reg_sort_e<THREADS, 2>(keys, n, big); break;
    case 4: reg_sort_e<THREADS, 4>(keys, n, big); break;
    case 8: reg_sort_e<THREADS, 8>(keys, n, big); break;
    default: reg_sort_e<THREADS, E>(keys, n, big); break;
  }
}

// Moves the ids and rows of the run of `len` records at flat position
// `start` so that its r-th record becomes the one at run position perm[r]
// (returns the calling thread's count of r where perm[r] != r):
// the run's rows, then its ids, copied as they lie into `stage` (16-byte
// aligned, STAGE_SLACK + len * (pw + 1) words), then written back in order,
// each word gathered from the stage. Both passes over device memory are
// contiguous, in 16-byte words where the rows' alignment allows (the stage
// starts at the rows' alignment); the random reads fall on the stage.
template <int THREADS, typename I, typename P>
__device__ int move_run(const Stage& a, long long start, I len,
                         const P* perm, uint32_t* stage) {
  const int pw = a.pw;
  uint32_t* rows = a.rows + start * pw;
  uint32_t* ids = a.ids + start;
  const I words = len * pw;
  const int lead = (int)((reinterpret_cast<uintptr_t>(rows) >> 2) & 3);
  stage += lead;  // rows + t and stage + t now share their alignment
  I head = (4 - lead) & 3;
  if (head > words) head = words;
  const I quads = (words - head) / 4, tail = head + quads * 4;
  const uint4* from4 = reinterpret_cast<const uint4*>(rows + head);
  uint4* stage4 = reinterpret_cast<uint4*>(stage + head);
#pragma unroll 4
  for (I q = threadIdx.x; q < quads; q += THREADS) stage4[q] = from4[q];
  for (I t = threadIdx.x; t < head; t += THREADS) stage[t] = rows[t];
  for (I t = tail + threadIdx.x; t < words; t += THREADS) stage[t] = rows[t];
  for (I j = threadIdx.x; j < len; j += THREADS) stage[words + j] = ids[j];
  __syncthreads();
  // word t of the rows (record t / pw, column t % pw) takes the word of the
  // same column of record perm[t / pw]
  uint4* to4 = reinterpret_cast<uint4*>(rows + head);
#pragma unroll 2
  for (I q = threadIdx.x; q < quads; q += THREADS) {
    const I t = head + 4 * q;
    I j = t / pw;
    int c = (int)(t - j * pw);
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = stage[(I)perm[j] * pw + c];
      if (++c == pw) {
        c = 0;
        ++j;
      }
    }
    to4[q] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (I t = threadIdx.x; t < head; t += THREADS)
    rows[t] = stage[(I)perm[t / pw] * pw + t % pw];
  for (I t = tail + threadIdx.x; t < words; t += THREADS)
    rows[t] = stage[(I)perm[t / pw] * pw + t % pw];
  int moved = 0;
  for (I r = threadIdx.x; r < len; r += THREADS) {
    ids[r] = stage[words + (I)perm[r]];
    moved += (I)perm[r] != r;
  }
  __syncthreads();
  return moved;
}

// The mid class's ranks: U keys of the run a thread (places threadIdx.x +
// u * THREADS), each ranked by the keys below it, all keys read from
// shared memory in turn; perm[rank] = place.
template <int THREADS, int U>
__device__ __forceinline__ void rank_keys(const u64* keys, int len,
                                          unsigned short* perm) {
  u64 mine[U];
  int rank[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * THREADS;
    mine[u] = e < len ? keys[e] : 0ull;
    rank[u] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const u64 x = keys[j];
#pragma unroll
    for (int u = 0; u < U; ++u) rank[u] += x < mine[u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * THREADS;
    if (e < len) perm[rank[u]] = (unsigned short)e;
  }
}

// A run of the mid class (at most PER_THREAD * THREADS records): keys
// (key bytes 4-9 << 16 | place) ranked by counting, no barrier between,
// then the ids and rows moved through shared memory.
template <int THREADS, int PER_THREAD>
__device__ int order_mid(const Stage& a, long long start, int len,
                          unsigned char* smem, int smem_bytes) {
  static_assert(PER_THREAD <= 8, "rank_keys is dispatched up to 8");
  const int pw = a.pw;
  const int perm_bytes = (2 * len + 15) & ~15;
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem);
  u64* keys = reinterpret_cast<u64*>(smem + perm_bytes);
  for (int j = threadIdx.x; j < len; j += THREADS)
    keys[j] = (tail48(a.rows + (start + j) * pw) << 16) | (u64)j;
  __syncthreads();
  switch ((len + THREADS - 1) / THREADS) {
    case 1: rank_keys<THREADS, 1>(keys, len, perm); break;
    case 2: rank_keys<THREADS, 2>(keys, len, perm); break;
    case 3: rank_keys<THREADS, 3>(keys, len, perm); break;
    case 4: rank_keys<THREADS, 4>(keys, len, perm); break;
    case 5: rank_keys<THREADS, 5>(keys, len, perm); break;
    case 6: rank_keys<THREADS, 6>(keys, len, perm); break;
    case 7: rank_keys<THREADS, 7>(keys, len, perm); break;
    default: rank_keys<THREADS, 8>(keys, len, perm); break;
  }
  __syncthreads();
  return move_run<THREADS, int>(a, start, len, perm,
                                reinterpret_cast<uint32_t*>(keys));
}

// A run of the large class of up to SORT_CAP records: sorted in registers
// and shared memory (reg_sort), then its rows and ids moved in one pass
// through `stage`, its share of the global scratch.
template <int THREADS>
__device__ int order_large(const Stage& a, long long start, int len,
                            unsigned char* smem, uint32_t* stage) {
  u64* keys = reinterpret_cast<u64*>(smem);
  const int pw = a.pw;
  for (int j = threadIdx.x; j < len; j += THREADS)
    keys[j] = (tail48(a.rows + (start + j) * pw) << 16) | (u64)j;
  __syncthreads();
  reg_sort<THREADS>(keys, len);
  unsigned short src[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = threadIdx.x + r * THREADS;
    src[r] = at < len ? (unsigned short)(keys[at] & 0xFFFF) : 0;
  }
  __syncthreads();
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = threadIdx.x + r * THREADS;
    if (at < len) perm[at] = src[r];
  }
  __syncthreads();
  const int perm_bytes = (2 * len + 15) & ~15;
  if (len <= a.smem_rows)  // the whole rows fit beside the order
    stage = reinterpret_cast<uint32_t*>(smem + perm_bytes);
  return move_run<THREADS, int>(a, start, len, perm, stage);
}

// Sorted u64s in arr[0, n) below x (or equal to it, where or_equal).
__device__ long long count_below(const u64* arr, long long n, u64 x,
                                 bool or_equal) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    const u64 y = arr[mid];
    if (y < x || (or_equal && y == x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A run longer than SORT_CAP: chunks sorted in shared memory, merged in
// global scratch (key bytes 4-9 and the place, twice: HUGE_WORDS a record),
// then its rows and ids moved in one pass through the rest of its scratch.
template <int THREADS>
__device__ __noinline__ int order_huge(const Stage& a, long long start,
                                        long long len,
                           unsigned char* smem, uint32_t* scratch) {
  u64* ka = reinterpret_cast<u64*>(scratch);
  u64* kb = ka + len;
  uint32_t* ia = reinterpret_cast<uint32_t*>(kb + len);
  uint32_t* ib = ia + len;
  u64* keys = reinterpret_cast<u64*>(smem);
  const int pw = a.pw;
  for (long long c0 = 0; c0 < len; c0 += SORT_CAP) {
    const int n = (int)(len - c0 < SORT_CAP ? len - c0 : SORT_CAP);
    for (int j = threadIdx.x; j < n; j += THREADS)
      keys[j] = (tail48(a.rows + (start + c0 + j) * pw) << 16) | (u64)j;
    __syncthreads();
    reg_sort<THREADS>(keys, n);
    for (int r = threadIdx.x; r < n; r += THREADS) {
      ka[c0 + r] = keys[r] >> 16;
      ia[c0 + r] = (uint32_t)(c0 + (long long)(keys[r] & 0xFFFF));
    }
    __syncthreads();
  }
  // merge neighbouring sorted chunks: a record's place is its own place in
  // its chunk plus the records of the other chunk before it (equal keys:
  // the left chunk's first, so places stay in order)
  for (long long w = SORT_CAP; w < len; w <<= 1) {
    for (long long p = threadIdx.x; p < len; p += THREADS) {
      const long long b = p / (2 * w) * (2 * w);
      const long long mid = b + w < len ? b + w : len;
      const long long end = b + 2 * w < len ? b + 2 * w : len;
      const u64 x = ka[p];
      const long long out =
          p < mid ? p + count_below(ka + mid, end - mid, x, false)
                  : b + (p - mid) + count_below(ka + b, mid - b, x, true);
      kb[out] = x;
      ib[out] = ia[p];
    }
    __syncthreads();
    u64* kt = ka;
    ka = kb;
    kb = kt;
    uint32_t* it = ia;
    ia = ib;
    ib = it;
  }
  return move_run<THREADS, long long>(a, start, len, ia,
                                      scratch + sort_words(len));
}

// The next run a block takes from its class's list; len 0 where none is
// left.
template <bool LARGE>
__device__ longlong2 next_run(const Stage& a) {
  const long long i = (long long)atomicAdd(
      a.state + (LARGE ? NEXT_LARGE : NEXT_MID), 1ull);
  const long long count = (long long)a.state[LARGE ? COUNT_LARGE : COUNT_MID];
  const long long cap = LARGE ? a.cap_large : a.cap_mid;
  return i < count && i < cap ? (LARGE ? a.large : a.mid)[i]
                              : make_longlong2(0, 0);
}

template <int THREADS, bool LARGE>
__global__ void __launch_bounds__(THREADS)
    key_tail_order(Stage a, uint32_t* scratch, long long scratch_len,
                   long long capacity, bool* overflow, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  __shared__ long long s_run[3];  // start, length, scratch offset
  if (!LARGE && blockIdx.x == 0 && threadIdx.x == 0) {
    // the mid class launches first: more pairs than the capacity, or a
    // list that dropped runs
    bool over = capacity >= 0 && (long long)a.state[PAIRS] > capacity;
    over |= (long long)a.state[COUNT_MID] > a.cap_mid;
    over |= (long long)a.state[COUNT_LARGE] > a.cap_large;
    *overflow = over;
  }
  int moved = 0;
  for (;;) {
    if (threadIdx.x == 0) {
      const longlong2 run = next_run<LARGE>(a);
      s_run[0] = run.x;
      s_run[1] = run.y;
      if (LARGE && run.y)
        s_run[2] = (long long)atomicAdd(
            a.state + CURSOR, (u64)scratch_words(run.y, a.pw, a.smem_rows));
    }
    __syncthreads();
    const long long start = s_run[0], len = s_run[1], off = s_run[2];
    __syncthreads();
    if (len == 0) break;
    if constexpr (LARGE) {
      if (off + scratch_words(len, a.pw, a.smem_rows) > scratch_len) {
        if (threadIdx.x == 0) *overflow = true;  // the run stays unordered
        continue;
      }
      if (len > SORT_CAP)
        moved += order_huge<THREADS>(a, start, len, order_smem, scratch + off);
      else
        moved += order_large<THREADS>(a, start, (int)len, order_smem,
                                      scratch + off);
    } else {
      moved += order_mid<THREADS, MID_MAX / THREADS>(a, start, (int)len,
                                                     order_smem, smem_bytes);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    moved += __shfl_down_sync(FULL, moved, off);
  if ((threadIdx.x & 31) == 0 && moved)
    atomicAdd(a.state + MOVED, (u64)moved);
}

constexpr int FIND_SMEM = FIND_WARPS * WINDOW * (FIND_COLS * 4 + 2);
static_assert(MID_SMEM >= MID_MAX * 10, "the mid class ranks in its stage");
// payload words up to which a mid-class run stages in one block's memory
constexpr int MAX_PW =
    (LARGE_SMEM - 64 - 2 * MID_MAX - 4 * STAGE_SLACK) / (4 * MID_MAX) - 1;

// The mid class's shared memory at pw payload words: the order and the
// staged rows and ids of its longest run.
int mid_smem(long long pw) {
  const long long need = 2 * MID_MAX + (STAGE_SLACK + MID_MAX * (pw + 1)) * 4;
  return (int)(need > MID_SMEM ? need : MID_SMEM);
}

// Per device: SMs, the large class's shared memory, and the blocks of each
// kernel an SM holds.
struct Fit {
  int sms = 0, large_smem = 0, find = 0;
};

int fit_of(Fit* out) {
  static Fit fits[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  Fit& f = fits[dev];
  if (!f.sms) {
    Fit g;
    if ((e = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&g.large_smem,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
      return (int)e;
    // the large class takes what the block may have beside its static
    // shared memory
    auto* large =
        key_tail_order<LARGE_THREADS, true>;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, large)) != cudaSuccess)
      return (int)e;
    g.large_smem -= (int)attr.sharedSizeBytes;
    if (g.large_smem > LARGE_SMEM) g.large_smem = LARGE_SMEM;
    g.large_smem &= ~15;
    if (g.large_smem < SORT_CAP * 8) return (int)cudaErrorInvalidConfiguration;
    if ((e = cudaFuncSetAttribute(large,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  g.large_smem)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &g.find, key_tail_find, FIND_THREADS, FIND_SMEM)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             key_tail_order<MID_THREADS, false>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, g.large_smem)) !=
            cudaSuccess)
      return (int)e;
    if (g.find < 1) g.find = 1;
    f = g;
  }
  *out = f;
  return 0;
}

Stage stage_of(const uint32_t* keys, uint32_t* ids, uint32_t* rows,
               const int32_t* valid, long long* state, long long* mid,
               long long* large, long long wl, long long m, long long pw,
               long long cap_mid, long long cap_large, const Fit& f) {
  // a run of the large class stages its rows in shared memory where they
  // fit beside its order (2 bytes a record)
  long long rows_fit =
      (f.large_smem - 16 - 4 * STAGE_SLACK) / (4 * (pw + 1) + 2);
  if (rows_fit > SORT_CAP) rows_fit = SORT_CAP;
  return Stage{keys,
               ids,
               rows,
               valid,
               reinterpret_cast<u64*>(state),
               reinterpret_cast<longlong2*>(mid),
               reinterpret_cast<longlong2*>(large),
               wl,
               m,
               cap_mid,
               cap_large,
               (int)pw,
               (int)rows_fit};
}

bool bad_shape(long long wl, long long m, long long pw, long long cap_mid,
               long long cap_large) {
  return wl < 0 || m < 0 || pw < 2 || pw > MAX_PW || cap_mid < 1 ||
         cap_large < 1 || m > (1LL << 40);
}

}  // namespace

// The sizes of a call over `slots` places of pw-word rows, into out[5]:
// the state's int64 counts, the mid list's entries, the large list's, the
// scratch words (-1 where
// capacity < 0: counted on the card, state[SCRATCH] after
// rt_key_tail_find) and the most payload words the kernels take.
// Under a capacity of pairs with no overflow at most 2 * capacity records
// are tied (a run of L records has L - 1 >= L / 2 pairs), a mid run holds
// at least TILE pairs and a large run at least MID_MAX, and a large run
// takes at most (pw + 1 + HUGE_WORDS) words a record and 16 more
// (scratch_words). Without one, each class's shortest run bounds its list.
// Returns cudaErrorInvalidValue where pw is outside [2, out[4]].
RT_API int rt_key_tail_sizes(long long slots, long long pw,
                             long long capacity, long long* out) {
  out[0] = STATE_LEN;
  out[4] = MAX_PW;
  if (slots < 0 || pw < 2 || pw > MAX_PW) return (int)cudaErrorInvalidValue;
  out[1] = slots / (TILE + 1) + 1;
  out[2] = slots / (MID_MAX + 1) + 1;
  out[3] = -1;
  if (capacity >= 0) {
    const long long tied = 2 * capacity < slots ? 2 * capacity : slots;
    if (capacity / TILE + 1 < out[1]) out[1] = capacity / TILE + 1;
    if (capacity / MID_MAX + 1 < out[2]) out[2] = capacity / MID_MAX + 1;
    out[3] = tied * (pw + 1 + HUGE_WORDS) + 16 * (tied / MID_MAX + 1);
  }
  return 0;
}

// keys/ids (wl, m) uint32 in (key word, id) order, rows (wl, m, pw), valid
// (wl,) int32. Zeroes state (STATE_LEN int64), then one launch of
// key_tail_find: the runs of up to 32 records ordered in place, longer ones
// listed as (start, length) in mid (cap_mid entries) and large (cap_large).
RT_API int rt_key_tail_find(const uint32_t* keys, uint32_t* ids,
                            uint32_t* rows, const int32_t* valid,
                            long long* state, long long* mid,
                            long long* large, long long wl, long long m,
                            long long pw, long long cap_mid,
                            long long cap_large, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(wl, m, pw, cap_mid, cap_large))
    return (int)cudaErrorInvalidValue;
  Fit f;
  if (int e = fit_of(&f)) return e;
  cudaError_t e = cudaMemsetAsync(state, 0, STATE_LEN * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  const long long groups = wl * ((m + GROUP * TILE - 1) / (GROUP * TILE));
  if (groups == 0) return 0;
  long long blocks = (groups + FIND_WARPS - 1) / FIND_WARPS;
  if (blocks > (long long)f.sms * f.find) blocks = (long long)f.sms * f.find;
  key_tail_find<<<(unsigned)blocks, FIND_THREADS, FIND_SMEM, st>>>(stage_of(
      keys, ids, rows, valid, state, mid, large, wl, m, pw, cap_mid,
      cap_large, f));
  RT_CHECK();
  return 0;
}

// The listed runs after rt_key_tail_find, one launch: the mid class
// (large_class = 0), which launches first and writes overflow (capacity >=
// 0 and more pairs than capacity, or a list that dropped a run; capacity <
// 0 holds every pair), or the large class (1), which sets it where the
// scratch cannot hold a run. scratch: scratch_len uint32 for the large
// class, rt_key_tail_sizes' words or state[SCRATCH] after rt_key_tail_find
// (null where that is 0). Each launch adds its moved records to
// state[MOVED].
RT_API int rt_key_tail_order(const uint32_t* keys, uint32_t* ids,
                             uint32_t* rows, const int32_t* valid,
                             long long* state, long long* mid,
                             long long* large, long long wl, long long m,
                             long long pw, long long cap_mid,
                             long long cap_large, long long capacity,
                             bool* overflow, uint32_t* scratch,
                             long long scratch_len, int large_class,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(wl, m, pw, cap_mid, cap_large) || scratch_len < 0)
    return (int)cudaErrorInvalidValue;
  Fit f;
  if (int e = fit_of(&f)) return e;
  const Stage s = stage_of(keys, ids, rows, valid, state, mid, large, wl, m,
                           pw, cap_mid, cap_large, f);
  if (large_class) {
    long long blocks = cap_large;
    if (blocks > f.sms) blocks = f.sms;
    key_tail_order<LARGE_THREADS, true>
        <<<(unsigned)blocks, LARGE_THREADS, f.large_smem, st>>>(
            s, scratch, scratch_len, capacity, overflow, f.large_smem);
  } else {
    int fit = 1;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, key_tail_order<MID_THREADS, false>,
        MID_THREADS, mid_smem(pw));
    if (e != cudaSuccess) return (int)e;
    long long blocks = (long long)f.sms * (fit > 1 ? fit : 1);
    if (blocks > cap_mid) blocks = cap_mid;
    key_tail_order<MID_THREADS, false>
        <<<(unsigned)blocks, MID_THREADS, mid_smem(pw), st>>>(
            s, scratch, scratch_len, capacity, overflow, mid_smem(pw));
  }
  RT_CHECK();
  return 0;
}
