// The grouping of slots by the id they hold, for every run kernel of the
// port (attr_scatter and K4b in attr_merge_bwd.cu, K3's per-Gaussian kernel in
// fine_bwd.cu, the per-Gaussian half in fine_bwd_split.cu): from the flattened
// slot ids idx (n int32) and n_rows, the run starts `starts` (n_rows + 1,
// int64) and `order` (n int32) such that the slots holding id j are
// order[starts[j] : starts[j + 1]] in ascending slot order.  Ids outside
// [0, n_rows) (-1 for an empty slot) hold nothing; order[starts[n_rows]:] is
// left unwritten.  It is part of the port of voge_tpu/ops/pallas_attr.py::
// _bwd_attr_kernel (:168) and _bwd_unified_kernel (:90), which match every
// candidate id against every slot on the MXU instead of grouping.
//
// Why its bits are torch.sort's.  The plain version (ops/cuda_attr.py::
// slot_runs_plain) takes torch.sort(key, stable=True) of key = id (n_rows
// where the id is out of range) and torch.searchsorted of the edges
// 0..n_rows.  A stable sort is unique: it orders by (key, slot).  This kernel orders the valid slots by
// (key, slot) as well, so order[:starts[n_rows]] holds the same values, and
// starts[j] is the number of valid slots with a key below j, which is what the
// left searchsorted returned.  Every run kernel downstream therefore reads the
// same slots in the same order and keeps its bits.  Only integers are added
// (shared-memory integer atomics commute), so two runs agree too.
//
// Design: a stable compaction, then a stable least-significant-digit radix
// sort of (key, slot) int32 pairs over the ceil(log2(n_rows)) bits the keys
// have, not a general sort of a 64-bit key.
//   The compaction drops the empty and out-of-range slots (84% of the slots
//   at the texture shapes, 57% at ShapeFitting) so that the sort moves only
//   the valid ones: count_kernel counts each tile's valid slots (TILE
//   consecutive slots a block), one block scans the counts, compact_kernel
//   writes each tile's valid (id, slot) pairs at its offset in slot order (a
//   ballot a warp round, the rank the popcount of the valid lanes below).
//   With one id this is the grouping.
//   Then ceil(bits / 8) digit passes, each on a digit of ceil(bits / passes)
//   bits (two 7-bit passes at 10,242 rows, three 7-bit passes at the 300K
//   cloud's 19 bits, one up to 256 rows).  The pairs are cut into tiles and
//   the tiles into one contiguous range a block, BLOCKS_AN_SM blocks an SM.
//   A pass is three kernels:
//   upsweep: each block's digit counts over its range (shared-memory integer
//            atomics, one a digit a warp: neighbouring pixels hold the same
//            ids), laid out (digit, block);
//   scan:    one block a digit scans its row of counts over the blocks and
//            writes the digit's total;
//   scatter: each block scans the digit totals for the digit bases and walks
//            its tiles in order.  It ranks a tile's items within the tile in
//            item order: warp w takes the items w * 256 ..., 32 at a time;
//            one ballot a digit bit gives the lanes with the same digit, the
//            rank among them is the popcount of those below, and per-warp
//            digit counters in shared memory, added over the warps in warp
//            order, place the warps.  It stages the tile in shared memory in
//            digit order and writes it out from there, so neighbouring
//            threads store to neighbouring addresses (a digit's items of a
//            tile are one run).  Item = base of its digit + the block's
//            offset in the digit + the tiles before it in the block + its
//            rank: stable.
// The last pass writes the slots to `order` and the keys beside them; one more
// kernel finds each row's start in the sorted keys by a binary search (the
// left searchsorted, written out).  The number of valid slots
// stays on the card (the compaction's scan writes it), so the wrapper never
// waits.
//
// What bounds it on the H100: bytes.  The function reads idx (4 B a slot) and
// writes order (4 B a valid slot) and starts.  The compaction reads idx twice
// and writes 8 B a valid slot; a digit pass moves ~20 B a valid slot (read the
// keys twice and the slots once, write both).  At the texture shapes (13.76 M
// slots, 2.23 M valid) that is ~0.2 GB, ~0.06 ms at 3.35 TB/s, against
// torch.sort's 64-bit sort of every slot.  The launches (3 + 3 a pass + 1) and
// the scatter's chain of block-wide steps a tile set the time at the small
// shapes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                   // items a thread, 32 apart
constexpr int TILE = THREADS * ITEMS;      // 2,048 consecutive items a block
constexpr int WARP_ITEMS = 32 * ITEMS;     // a warp's consecutive share
constexpr int MAX_BINS = 256;              // 8-bit digits at most
constexpr int BLOCKS_AN_SM = 4;            // digit-pass blocks resident an SM
constexpr unsigned FULL = 0xffffffffu;

struct Pass {
  const int* keys_in;   // the (key, slot) pairs in the previous pass's order
  const int* slots_in;
  int* keys_out;        // this pass's pairs, in the order of its digit
  int* slots_out;
  int* counts;          // (bins, gridDim.x) digit counts of each block, then their scan
  int* totals;          // (bins) items of each digit
  const int* n_valid;   // the pairs (valid slots)
  int shift, dbits, bins;
};

// Block b's tiles [t0, t1) of the n_valid pairs: the tiles split into
// gridDim.x contiguous ranges that differ by one tile at most.
__device__ __forceinline__ void block_tiles(const Pass& a, long long& items, int& t0, int& t1) {
  items = *a.n_valid;
  const long long tiles = (items + TILE - 1) / TILE;
  t0 = (int)(tiles * blockIdx.x / gridDim.x);
  t1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
}

// The lanes whose item is valid and has this lane's digit (for a valid
// lane): one ballot a digit bit.  ``valid`` is the ballot of the valid lanes.
__device__ __forceinline__ unsigned digit_peers(int dig, unsigned valid, int dbits) {
  unsigned peers = valid;
  for (int b = 0; b < dbits; ++b) {
    const bool bit = (dig >> b) & 1;
    const unsigned set = __ballot_sync(FULL, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Exclusive prefix of v over the block's threads in thread order; every
// thread must call it.  s_tmp holds WARPS ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_tmp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = s_tmp[w];
    if (w < warp) before += t;
    total += t;
  }
  __syncthreads();
  return before + x - v;
}

// Slot i is valid: its id lies in [0, n_rows).
__device__ __forceinline__ bool valid_slot(const int* idx, long long i, long long n, int n_rows,
                                           int& id) {
  id = i < n ? idx[i] : -1;
  return id >= 0 && id < n_rows;
}

// The compaction, first step: each tile's valid slots (one a block).
__global__ void __launch_bounds__(THREADS) count_kernel(const int* __restrict__ idx,
                                                        long long n, int n_rows,
                                                        int* __restrict__ counts) {
  __shared__ int s_tmp[WARPS];
  const long long i0 = (long long)blockIdx.x * TILE + threadIdx.x;
  bool ok[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    int id;
    ok[r] = valid_slot(idx, i0 + r * THREADS, n, n_rows, id);
  }
  int mine = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) mine += ok[r];
  int total;
  block_exclusive_scan(mine, s_tmp, total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// The compaction, last step: each tile's valid slots as (id, slot) pairs at
// its offset (the scanned counts), in slot order.
__global__ void __launch_bounds__(THREADS) compact_kernel(const int* __restrict__ idx,
                                                          long long n, int n_rows,
                                                          const int* __restrict__ offsets,
                                                          int* __restrict__ keys_out,
                                                          int* __restrict__ slots_out) {
  __shared__ int s_tmp[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 = (long long)blockIdx.x * TILE + warp * WARP_ITEMS + lane;
  int id[ITEMS];
  unsigned valid[ITEMS];
  int in_warp = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) valid_slot(idx, i0 + 32 * r, n, n_rows, id[r]);
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    valid[r] = __ballot_sync(FULL, id[r] >= 0 && id[r] < n_rows);
    in_warp += __popc(valid[r]);
  }
  int total;  // the warps before this one, in warp order
  int at = block_exclusive_scan(lane == 0 ? in_warp : 0, s_tmp, total);
  at = __shfl_sync(FULL, at, 0) + offsets[blockIdx.x];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if ((valid[r] >> lane) & 1) {
      const int dest = at + __popc(valid[r] & below);
      keys_out[dest] = id[r];
      slots_out[dest] = (int)(i0 + 32 * r);
    }
    at += __popc(valid[r]);
  }
}

// A digit pass, first step: each block's digit counts over its range
// (shared-memory integer atomics, one a digit a warp: neighbouring pixels
// hold the same ids), laid out (digit, block).
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) upsweep_kernel(const Pass a) {
  __shared__ int s_hist[MAX_BINS];
  long long items;
  int t0, t1;
  block_tiles(a, items, t0, t1);
  for (int d = threadIdx.x; d < a.bins; d += THREADS) s_hist[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int tile = t0; tile < t1; ++tile) {
    int key[ITEMS];
    const long long i0 = (long long)tile * TILE + threadIdx.x;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)  // all the loads first
      key[r] = i0 + r * THREADS < items ? a.keys_in[i0 + r * THREADS] : -1;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const bool ok = key[r] >= 0;
      const int dig = ok ? (key[r] >> a.shift) & (a.bins - 1) : 0;
      const unsigned valid = __ballot_sync(FULL, ok);
      if (valid == 0) continue;  // the same for the whole warp
      const unsigned peers = digit_peers(dig, valid, a.dbits);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&s_hist[dig], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < a.bins; d += THREADS)
    a.counts[(size_t)d * gridDim.x + blockIdx.x] = s_hist[d];
}

// Block d: the exclusive scan of row d of ``counts`` (n_cols entries) in
// place, and the row's total into totals[d].
__global__ void __launch_bounds__(THREADS) scan_kernel(int* __restrict__ counts,
                                                       int* __restrict__ totals, int n_cols) {
  __shared__ int s_tmp[WARPS];
  int* c = counts + (size_t)blockIdx.x * n_cols;
  const int seg = (n_cols + THREADS - 1) / THREADS;
  const int lo = min(n_cols, (int)threadIdx.x * seg), hi = min(n_cols, lo + seg);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += c[t];
  int total;
  int run = block_exclusive_scan(sum, s_tmp, total);
  for (int t = lo; t < hi; ++t) {
    const int v = c[t];
    c[t] = run;
    run += v;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// A digit pass, last step.
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) scatter_kernel(const Pass a) {
  __shared__ int s_next[MAX_BINS];          // the block's next position in each digit
  __shared__ int s_start[MAX_BINS];         // each digit's start in the staged tile
  __shared__ int s_warp[WARPS][MAX_BINS];   // per-warp digit counts, then offsets
  __shared__ int s_key[TILE], s_slot[TILE]; // the tile, staged in digit order
  __shared__ int s_tmp[WARPS];
  long long items;
  int t0, t1;
  block_tiles(a, items, t0, t1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d_own = threadIdx.x;

  // where the block's items of each digit start: the digit's base (the scan
  // of the digit totals) + the block's offset in the digit
  int total;
  const int tot = d_own < a.bins ? a.totals[d_own] : 0;
  const int base = block_exclusive_scan(tot, s_tmp, total);
  if (d_own < a.bins) s_next[d_own] = base + a.counts[(size_t)d_own * gridDim.x + blockIdx.x];
  const unsigned below = (1u << lane) - 1u;

  for (int tile = t0; tile < t1; ++tile) {
    for (int q = threadIdx.x; q < WARPS * MAX_BINS; q += THREADS) (&s_warp[0][0])[q] = 0;
    __syncthreads();
    // each item's rank among the items of its digit in its warp's share, in
    // item order: round r holds items i0 + 32 r + lane
    int key[ITEMS], slot[ITEMS], dig[ITEMS], rank[ITEMS];
    const long long i0 = (long long)tile * TILE + warp * WARP_ITEMS + lane;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const bool ok = i0 + 32 * r < items;
      key[r] = ok ? a.keys_in[i0 + 32 * r] : 0;
      slot[r] = ok ? a.slots_in[i0 + 32 * r] : 0;
      dig[r] = ok ? (key[r] >> a.shift) & (a.bins - 1) : -1;
    }
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const unsigned valid = __ballot_sync(FULL, dig[r] >= 0);
      rank[r] = 0;
      if (valid == 0) continue;  // the same for the whole warp
      const unsigned peers = digit_peers(dig[r], valid, a.dbits);
      int prior = 0;
      if (dig[r] >= 0) prior = s_warp[warp][dig[r]];
      __syncwarp();
      if (dig[r] >= 0 && lane == __ffs(peers) - 1)
        s_warp[warp][dig[r]] = prior + __popc(peers);
      __syncwarp();
      rank[r] = prior + __popc(peers & below);
    }
    __syncthreads();
    // the warps' offsets within each digit (warp order) and the tile's count
    int cnt = 0;
    if (d_own < a.bins) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int t = s_warp[w][d_own];
        s_warp[w][d_own] = cnt;
        cnt += t;
      }
    }
    int in_tile;
    const int start = block_exclusive_scan(cnt, s_tmp, in_tile);  // syncs: s_warp is read below
    if (d_own < a.bins) s_start[d_own] = start;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int d = dig[r];
      if (d < 0) continue;
      const int at = s_start[d] + s_warp[warp][d] + rank[r];
      s_key[at] = key[r];
      s_slot[at] = slot[r];
    }
    __syncthreads();
    // out in digit order: neighbouring threads write neighbouring positions
    for (int q = threadIdx.x; q < in_tile; q += THREADS) {
      const int k = s_key[q], d = (k >> a.shift) & (a.bins - 1);
      const int dest = s_next[d] + (q - s_start[d]);
      a.keys_out[dest] = k;
      a.slots_out[dest] = s_slot[q];
    }
    __syncthreads();
    if (d_own < a.bins) s_next[d_own] += cnt;
  }
}

// starts[j] = the first position of the sorted keys whose key is j or more
// (n_valid where there is none): a binary search a row, so a run of empty
// rows costs no thread more than a full one.
__global__ void __launch_bounds__(THREADS) starts_kernel(const int* __restrict__ keys,
                                                         const int* __restrict__ n_valid,
                                                         long long* __restrict__ starts,
                                                         int n_rows) {
  const int v = *n_valid;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j <= n_rows;
       j += (long long)gridDim.x * THREADS) {
    int lo = 0, hi = v;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (keys[mid] < j) lo = mid + 1;
      else hi = mid;
    }
    starts[j] = lo;
  }
}

struct Plan {
  int passes, dbits, bins;
};

Plan plan(long long n_rows) {
  int bits = 0;  // the bits of the largest key, n_rows - 1
  while ((1LL << bits) < n_rows) ++bits;
  Plan p;
  p.passes = (bits + 7) / 8;
  p.dbits = p.passes ? (bits + p.passes - 1) / p.passes : 0;
  p.bins = 1 << p.dbits;
  return p;
}

constexpr int MAX_BLOCKS = 132 * 2 * BLOCKS_AN_SM;  // the scratch's room for counts

// Blocks of a digit pass: BLOCKS_AN_SM on each SM (one range of tiles each);
// the SM count is read once (the port drives one card).
int pass_grid() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms * BLOCKS_AN_SM < MAX_BLOCKS ? sms * BLOCKS_AN_SM : MAX_BLOCKS;
}

long long n_tiles(long long n) { return (n + TILE - 1) / TILE; }

// Room for counts: one a tile for the compaction, one a (digit, block) after.
long long counts_len(long long n) {
  const long long digits = (long long)MAX_BINS * MAX_BLOCKS;
  return n_tiles(n) > digits ? n_tiles(n) : digits;
}

}  // namespace

// Int32 elements of the scratch buffer voge_slot_runs needs: two (key, slot)
// buffers of n pairs, the counts, the digit totals and the valid count.
extern "C" long long voge_slot_runs_scratch(long long n) {
  return 4 * n + counts_len(n) + MAX_BINS + 4;
}

// The digit passes a grouping of ids below n_rows takes (0 for one id: the
// compaction is the grouping).
extern "C" int voge_slot_runs_passes(long long n_rows) { return plan(n_rows).passes; }

// ``idx`` (n int32 slot ids); ``order`` (n int32) receives the valid slots
// grouped by id in slot order, ``starts`` (n_rows + 1 int64) each id's first
// position; ``scratch`` holds voge_slot_runs_scratch(n) int32s.
extern "C" int voge_slot_runs(const void* idx, void* order, void* starts, void* scratch,
                              long long n, long long n_rows, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || n_rows <= 0 || n_rows >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Plan pl = plan(n_rows);
  const long long tiles = n_tiles(n);
  int* sc = (int*)scratch;
  int* buf[2][2] = {{sc, sc + n}, {sc + 2 * n, sc + 3 * n}};  // [pass & 1][keys, slots]
  int* counts = sc + 4 * n;
  int* totals = counts + counts_len(n);
  int* n_valid = totals + MAX_BINS;

  // the compaction: the valid slots' (id, slot) pairs in slot order
  count_kernel<<<(unsigned)tiles, THREADS, 0, s>>>((const int*)idx, n, (int)n_rows, counts);
  scan_kernel<<<1, THREADS, 0, s>>>(counts, n_valid, (int)tiles);
  compact_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      (const int*)idx, n, (int)n_rows, counts, buf[0][0], pl.passes ? buf[0][1] : (int*)order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the digit passes over the pairs: pass p reads buffer p & 1
  const int grid = pass_grid();
  Pass a = {};
  a.counts = counts;
  a.totals = totals;
  a.n_valid = n_valid;
  a.dbits = pl.dbits;
  a.bins = pl.bins;
  for (int p = 0; p < pl.passes; ++p) {
    a.shift = p * pl.dbits;
    a.keys_in = buf[p & 1][0];
    a.slots_in = buf[p & 1][1];
    a.keys_out = buf[(p + 1) & 1][0];
    a.slots_out = p == pl.passes - 1 ? (int*)order : buf[(p + 1) & 1][1];
    upsweep_kernel<<<grid, THREADS, 0, s>>>(a);
    scan_kernel<<<pl.bins, THREADS, 0, s>>>(counts, totals, grid);
    scatter_kernel<<<grid, THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_rows + 1 + THREADS - 1) / THREADS;
  starts_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), THREADS, 0, s>>>(
      buf[pl.passes & 1][0], n_valid, (long long*)starts, (int)n_rows);
  return (int)cudaGetLastError();
}
