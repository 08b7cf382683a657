// Segment sum for Hopper (sm_90a): the dense gradient of a row gather,
//
//     out[v, :] = sum_{i : ids[i] = v} g[i, :]        out is [V, W] float32
//
// for int64 ids in any order; an id outside [0, V) adds nothing.
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_kernels.py
// sorted_segment_scatter_T (K1, the W-major [W, V_pad] output of
// embedding_grad_T) and sorted_segment_scatter (K2, the row-major
// [V_pad, W] output of embedding_grad). Both computed this sum as tiled
// one-hot matmuls on the MXU, because the TPU's scatter emitter handles
// duplicate row updates serially, and both took ids already sorted by
// jax.lax.sort_key_val (int32 keys, int32 positions) outside the Pallas
// body. The port's tables are row-major, so one row-major kernel serves
// both contracts and no one-hot is ever formed.
//
// What bounds it on the H100: bytes, and latency where a step has too
// little work to fill the card. The sum is one add per gradient element
// (N*W: 638,976 x 17 for the fused Criteo table at batch 16384), far below
// the card's arithmetic. The least bytes are the ids (8 N), the gradients
// (4 N W) and the dense table written once (4 V W: 57 MB at the Criteo
// tables of 840,704 rows, most of that bound). The steps below move:
//   1. the memset: the 4 V W bytes of the dense table, at the memory's rate;
//   2. prep_keys: 8 N read, 8 N written;
//   3. the sort: 16 N bytes a pass. With int64 keys and int64 positions a
//      stable radix sort makes 8 passes over 16-byte pairs; here the keys
//      and positions are 32-bit and only the bits a row id can have are
//      sorted (end_bit = bit length of V, the out-of-range sentinel V
//      included): 20 bits, 3 passes of 8 bytes a pair, at 840,704 rows, 13
//      bits (2 passes) at the 4,096-row small table. At a few hundred
//      thousand pairs a pass is a single wave of CUB's tiles, so it costs a
//      tile's latency more than its bytes (about 12 us a pass at 229,376
//      and at 638,976 pairs on an H100 80GB HBM3 at 700 W);
//   4. the chunk sums: 8 N of sorted pairs read coalesced, each gradient row
//      read once at a random address (4 W bytes in 32-byte sectors), each
//      touched output row written once;
//   5. the carry: 8 W bytes of partials per chunk.
//
// One C call (segment_sum) makes the whole sum on the caller's stream and
// allocates nothing: the caller passes the output and one workspace of
// segment_sum_workspace_bytes(n, w, end_bit) bytes, from which the keys,
// the positions, their sorted copies, the chunk partials and the sort's
// temporary storage are carved, each 256-byte aligned. So the call has no
// torch op but two allocations, and it can be captured in a CUDA graph. In
// stream order:
//   1. cudaMemsetAsync zeroes out (rows no id touches stay zero; the
//      optimizer is dense over the table). Writing each row exactly once
//      instead would still write all 4 V W bytes, which the memset already
//      writes at the memory's rate;
//   2. prep_keys turns each id into a uint32 key (an id outside [0, V)
//      becomes the sentinel V, which sorts last and is never written) and
//      writes the int32 positions 0..N-1;
//   3. cub::DeviceRadixSort::SortPairs sorts (key, position) pairs over
//      bits [0, end_bit), stably, so each segment keeps input order. The
//      sort is not the TPU kernel's body (the JAX package sorts outside its
//      pallas_call) and comes with the CUDA toolkit's headers;
//   4. segment_chunks sums: the sorted stream is cut into chunks of CHUNK
//      entries, one warp each, reading its keys and positions coalesced and
//      the gradient rows through the positions (a sorted copy of the rows
//      would make the same random reads and then write and read them once
//      more). A warp first loads 32 entries' values at once, so 32 loads
//      are in flight per lane, then sums them in order. At W <= 16 a warp
//      step takes E = 32 / next_pow2(W) entries, one group of next_pow2(W)
//      lanes each, and sums the pieces of the step with a segmented
//      shuffle scan in a fixed order (at W = 1 all 32 lanes work instead of
//      one). At W > 16 lane j takes column j of one entry a step (a second
//      grid dimension walks column tiles of 32 when W > 32), and one ballot
//      per 32 entries marks where pieces end, so a step is an add and a
//      branch the whole warp takes alike. A piece (a run of equal keys
//      inside a chunk) that is a whole segment is written to its row
//      directly; every chunk also writes the sums of its first and last
//      pieces (head, tail);
//   5. segment_carry gives each segment that crosses a chunk boundary to
//      the chunk it starts in, which finds how many chunks the segment
//      covers with one ballot per 32 chunks and adds their heads to its
//      tail in chunk order. Segment lengths run from 1 to B (a vocab-3
//      field puts about B/3 updates on one row), so a long segment is
//      summed in CHUNK-entry pieces by many warps, and only their partials
//      in sequence.
// Every output row has exactly one writer and there are no float atomics,
// so two calls give bitwise-equal results.
//
// The sparse mode (segment_sum_sparse) gives the same sums without the
// dense table: the distinct ids in ascending order, each with its summed
// row, and their count, in buffers of N entries (N ids have at most N
// distinct rows), the count on the card, so a step that uses it captures
// into one CUDA graph and never writes a buffer of the table's size. It
// exists for tables far larger than a step's ids (DLRM's 26.5M rows of
// 128 columns: the dense output alone would be 13.6 GB a step). After the
// sort (with prep_keys_sparse in place of prep_keys):
//   a. run_starts flags each sorted entry that begins the run of a real
//      key, and cub::DeviceScan::InclusiveSum turns the flags into each
//      entry's run number plus one;
//   b. compact_runs replaces every sorted key by its run's number (the
//      ids out of range by N, which is no run's), writes each run's id at
//      its number, the sentinel num_rows at every place past the count,
//      and the count;
//   c. segment_chunks and segment_carry sum as in the dense mode over the
//      run numbers, which are sorted and equal inside a run exactly where
//      the keys are, so each run's sum goes to its own row of the compact
//      output, in the same order as the dense mode adds it.
// grad_rows (int32 [N]) names the gradient row of each id: a bag
// of ids pooled into one row gives each of its ids that row's gradient
// (prep_keys_sparse writes grad_rows[i] as entry i's position), so the
// broadcast rows are never written out. The stable sort keeps each run in
// input order, so the sums equal those of the broadcast gradient bitwise.
// Rows of the compact output past the count are not written.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
// The C entry points return the cudaError_t of their calls.

#include <cstdint>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;            // sorted entries per warp
constexpr int WARPS = 8;              // warps (chunks) per block
constexpr int PER_LANE = CHUNK / 32;  // keys and positions each lane loads
constexpr unsigned FULL = 0xffffffffu;
// the key of an entry past the chunk's end: above every real key, since
// keys are at most V < 2^31 - 1
constexpr uint32_t NO_KEY = 0xffffffffu;
constexpr size_t ALIGN = 256;
constexpr long long MAX_N = (1LL << 31) - 1;
constexpr long long MAX_ROWS = (1LL << 31) - 2;

__global__ void prep_keys(const long long* __restrict__ ids,
                          uint32_t* __restrict__ keys, int* __restrict__ pos,
                          int n, long long num_rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long id = ids[i];
  keys[i] = static_cast<uint32_t>(id >= 0 && id < num_rows ? id : num_rows);
  pos[i] = static_cast<int>(i);
}

// prep_keys for the sparse mode: entry i's position is its gradient row,
// grad_rows[i].
__global__ void prep_keys_sparse(const long long* __restrict__ ids,
                                 const int* __restrict__ grad_rows,
                                 uint32_t* __restrict__ keys,
                                 int* __restrict__ pos, int n,
                                 long long num_rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long id = ids[i];
  keys[i] = static_cast<uint32_t>(id >= 0 && id < num_rows ? id : num_rows);
  pos[i] = grad_rows[i];
}

// flags[i] = 1 where sorted entry i begins the run of a key in range.
__global__ void run_starts(const uint32_t* __restrict__ sk,
                           int* __restrict__ flags, int n,
                           uint32_t num_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = sk[i];
  flags[i] = k < num_rows && (i == 0 || sk[i - 1] != k);
}

// incl: the inclusive sum of run_starts' flags. Each sorted key becomes its
// run's number (`rk`; N for an id out of range), each run's id goes to
// uniq at that number, the places from the count on get num_rows, and
// *count the number of runs.
__global__ void compact_runs(const uint32_t* __restrict__ sk,
                             const int* __restrict__ incl,
                             uint32_t* __restrict__ rk,
                             long long* __restrict__ uniq,
                             long long* __restrict__ count, int n,
                             uint32_t num_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int runs = incl[n - 1];
  const uint32_t k = sk[i];
  const bool real = k < num_rows;
  rk[i] = real ? static_cast<uint32_t>(incl[i] - 1) : static_cast<uint32_t>(n);
  if (real && (i == 0 || sk[i - 1] != k)) uniq[incl[i] - 1] = k;
  if (i >= runs) uniq[i] = num_rows;
  if (i == 0) *count = runs;
}

// One warp per chunk of sorted (key, position) pairs: whole segments go to
// `out`; the first and last piece of every chunk go to head / tail
// ([n_chunks, w]). E entries per warp step, P = 32 / E lanes per entry.
template <int E>
__global__ void __launch_bounds__(WARPS * 32)
segment_chunks(const uint32_t* __restrict__ sk, const int* __restrict__ sp,
               const float* __restrict__ g, float* __restrict__ out,
               float* __restrict__ head, float* __restrict__ tail, int n,
               int w, uint32_t num_rows, int n_chunks) {
  constexpr int P = 32 / E;
  constexpr int STEPS = 32 / E;  // warp steps per 32 entries
  const int lane = threadIdx.x & 31;
  const int e = lane / P;   // this lane's entry within a step
  const int cl = lane % P;  // this lane's column within the tile
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int col = blockIdx.y * P + cl;
  const bool live = col < w;
  const long long lo = static_cast<long long>(c) * CHUNK;
  const int len = static_cast<int>(min(static_cast<long long>(CHUNK), n - lo));

  uint32_t my_key[PER_LANE];
  int my_pos[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int i = k * 32 + lane;
    my_key[k] = i < len ? sk[lo + i] : NO_KEY;
    my_pos[k] = i < len ? sp[lo + i] : 0;
  }
  const uint32_t first_key = __shfl_sync(FULL, my_key[0], 0);
  const uint32_t last_key = sk[lo + len - 1];
  // does the first piece continue a segment of the previous chunk, and the
  // last piece one of the next?
  const bool first_cont = c > 0 && sk[lo - 1] == first_key;
  const bool last_cont = lo + len < n && sk[lo + len] == last_key;
  const long long part = static_cast<long long>(c) * w + col;
  // a piece of key `key` with sum `s` has ended: a whole segment goes to its
  // row, the chunk's first and last pieces to head / tail
  auto end_piece = [&](uint32_t key, float s) {
    const bool is_first = key == first_key;
    const bool is_last = key == last_key;
    if (is_first) head[part] = s;
    if (is_last) tail[part] = s;
    if (!(is_first && first_cont) && !(is_last && last_cont) &&
        key < num_rows)
      out[static_cast<long long>(key) * w + col] = s;
  };

  float acc = 0.0f;    // the open piece's sum so far
  bool carry = false;  // does the open piece run on into this step?
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    // the key after this block of 32: the next block's first
    const uint32_t next_block =
        k + 1 < PER_LANE ? __shfl_sync(FULL, my_key[min(k + 1, PER_LANE - 1)], 0)
                         : NO_KEY;
    // all 32 entries' values first: 32 / E loads in flight per lane
    float v[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int j = u * E + e;
      const int src = __shfl_sync(FULL, my_pos[k], j);
      v[u] = live && k * 32 + j < len
                 ? __ldg(g + static_cast<long long>(src) * w + col)
                 : 0.0f;
    }
    if constexpr (E == 1) {
      // the block's entries that end a piece, one bit each, from one ballot:
      // a warp step is then an add and a uniform branch
      const int i = k * 32 + lane;
      uint32_t next = __shfl_down_sync(FULL, my_key[k], 1);
      if (lane == 31) next = next_block;
      const unsigned ends = __ballot_sync(
          FULL, i < len && (i == len - 1 || next != my_key[k]));
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float s = carry ? acc + v[u] : v[u];
        carry = ((ends >> u) & 1u) == 0;
        if (!carry) {
          const uint32_t key = __shfl_sync(FULL, my_key[k], u);
          if (live) end_piece(key, s);
        }
        acc = s;
      }
    } else {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int j = u * E + e;
        const int i = k * 32 + j;
        const uint32_t key = __shfl_sync(FULL, my_key[k], j);
        const uint32_t next_in = __shfl_sync(FULL, my_key[k], (j + 1) & 31);
        const uint32_t next = j + 1 < 32 ? next_in : next_block;
        // segmented inclusive scan over the step's E entries, in a fixed
        // order: s = sum of this step's part of the piece up to entry e
        float s = v[u];
        const uint32_t prev = __shfl_up_sync(FULL, key, P);
        int starts = e == 0 || prev != key;
#pragma unroll
        for (int d = 1; d < E; d <<= 1) {
          const float up_s = __shfl_up_sync(FULL, s, d * P);
          const int up_starts = __shfl_up_sync(FULL, starts, d * P);
          if (e >= d) {
            if (!starts) s = up_s + s;
            starts |= up_starts;
          }
        }
        // the step's first piece continues the open one
        const uint32_t key0 = __shfl_sync(FULL, key, cl);
        if (carry && key == key0) s = acc + s;
        const bool valid = i < len;
        const bool ends = valid && (i == len - 1 || next != key);
        if (ends && live) end_piece(key, s);
        // the piece of the step's last entry stays open unless it ended
        const int last_lane = (E - 1) * P + cl;
        acc = __shfl_sync(FULL, s, last_lane);
        carry = __shfl_sync(FULL, static_cast<int>(valid && !ends),
                            last_lane);
      }
    }
  }
}

// One warp per chunk whose last piece starts a segment that runs on past
// the chunk: that segment's sum is its tail plus the heads of the chunks it
// covers, added in chunk order.
__global__ void __launch_bounds__(WARPS * 32)
segment_carry(const uint32_t* __restrict__ sk, const float* __restrict__ head,
              const float* __restrict__ tail, float* __restrict__ out, int w,
              uint32_t num_rows, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) return;  // the last chunk's segments end in it
  const long long lo = static_cast<long long>(c) * CHUNK;
  const long long hi = lo + CHUNK;  // not the last chunk: a full one
  const uint32_t row = sk[hi - 1];
  if (sk[hi] != row) return;  // the last piece ends in this chunk
  // the last piece starts here unless the whole chunk is one piece that
  // continues a segment of the previous chunk
  if (sk[lo] == row && c > 0 && sk[lo - 1] == row) return;
  if (row >= num_rows) return;  // the sentinel: ids out of range
  // the chunks after c that begin with `row` are a run (the keys are
  // sorted): count them 32 at a time
  int span = 0;
  for (int base = c + 1; base < n_chunks; base += 32) {
    const int k = base + lane;
    const bool same = k < n_chunks && sk[static_cast<long long>(k) * CHUNK] == row;
    const unsigned run = __ballot_sync(FULL, same);
    if (run == FULL) {
      span += 32;
      continue;
    }
    span += __ffs(~run) - 1;
    break;
  }
  const int col = blockIdx.y * 32 + lane;
  if (col >= w) return;
  float acc = tail[static_cast<long long>(c) * w + col];
#pragma unroll 8
  for (int k = 1; k <= span; ++k)
    acc += head[static_cast<long long>(c + k) * w + col];
  out[static_cast<long long>(row) * w + col] = acc;
}

size_t align_up(size_t x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }

// Byte offsets of the workspace's parts; the sort's temporary storage is
// the rest, from `temp` on.
struct Layout {
  size_t keys0, keys1, pos0, pos1, head, tail, incl, temp;
};

// The sparse mode takes one more int per entry (`incl`, the run numbers'
// inclusive sums); the dense mode's offsets are the same either way.
Layout carve(long long n, int w, bool sparse = false) {
  const size_t chunks = static_cast<size_t>((n + CHUNK - 1) / CHUNK);
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off = align_up(off + bytes);
    return at;
  };
  Layout L;
  L.keys0 = take(4 * static_cast<size_t>(n));
  L.keys1 = take(4 * static_cast<size_t>(n));
  L.pos0 = take(4 * static_cast<size_t>(n));
  L.pos1 = take(4 * static_cast<size_t>(n));
  L.head = take(4 * chunks * w);
  L.tail = take(4 * chunks * w);
  L.incl = sparse ? take(4 * static_cast<size_t>(n)) : off;
  L.temp = off;
  return L;
}

bool bad_shape(long long n, int w, int end_bit) {
  return n < 0 || n > MAX_N || w <= 0 || end_bit < 1 || end_bit > 31;
}

template <int E>
cudaError_t launch_chunks(dim3 grid, cudaStream_t s, const uint32_t* sk,
                          const int* sp, const float* g, float* out,
                          float* head, float* tail, int n, int w,
                          uint32_t num_rows, int n_chunks) {
  segment_chunks<E><<<grid, WARPS * 32, 0, s>>>(sk, sp, g, out, head, tail,
                                                n, w, num_rows, n_chunks);
  return cudaGetLastError();
}

// Steps 4 and 5 over n sorted (key, position) pairs: each run of a key
// below num_rows summed into out's row of that key.
cudaError_t sum_sorted(cudaStream_t s, const uint32_t* sk, const int* sp,
                       const float* g, float* out, float* head, float* tail,
                       int ni, int w, uint32_t rows, int n_chunks) {
  cudaError_t err;
  const unsigned blocks = (n_chunks + WARPS - 1) / WARPS;
  const dim3 one_tile(blocks, 1);
  if (w == 1)
    err = launch_chunks<32>(one_tile, s, sk, sp, g, out, head, tail, ni, w, rows, n_chunks);
  else if (w == 2)
    err = launch_chunks<16>(one_tile, s, sk, sp, g, out, head, tail, ni, w, rows, n_chunks);
  else if (w <= 4)
    err = launch_chunks<8>(one_tile, s, sk, sp, g, out, head, tail, ni, w, rows, n_chunks);
  else if (w <= 8)
    err = launch_chunks<4>(one_tile, s, sk, sp, g, out, head, tail, ni, w, rows, n_chunks);
  else if (w <= 16)
    err = launch_chunks<2>(one_tile, s, sk, sp, g, out, head, tail, ni, w, rows, n_chunks);
  else
    err = launch_chunks<1>(dim3(blocks, (w + 31) / 32), s, sk, sp, g, out,
                           head, tail, ni, w, rows, n_chunks);
  if (err != cudaSuccess || n_chunks == 1) return err;
  segment_carry<<<dim3(blocks, (w + 31) / 32), WARPS * 32, 0, s>>>(
      sk, head, tail, out, w, rows, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace `segment_sum` needs for n ids of width w sorted
// over end_bit bits, into *bytes.
extern "C" int segment_sum_workspace_bytes(long long n, int w, int end_bit,
                                           unsigned long long* bytes) {
  *bytes = 0;
  if (bad_shape(n, w, end_bit)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  size_t temp_bytes = 0;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> pos(nullptr, nullptr);
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, temp_bytes, keys, pos, static_cast<int>(n), 0, end_bit);
  *bytes = carve(n, w).temp + temp_bytes;
  return static_cast<int>(err);
}

// ids: [n] int64; g: [n, w] float32; out: [num_rows, w] float32, written
// whole; workspace: ws_bytes >= segment_sum_workspace_bytes(n, w, end_bit),
// 256-byte aligned. end_bit: the bit length of num_rows. Launches on
// `stream`, does not synchronise.
extern "C" int segment_sum(const void* ids_p, const void* g_p, void* out_p,
                           void* ws_p, unsigned long long ws_bytes,
                           long long n, int w, long long num_rows, int end_bit,
                           void* stream) {
  if (bad_shape(n, w, end_bit) || num_rows <= 0 || num_rows > MAX_ROWS ||
      (num_rows >> end_bit) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(out_p);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(num_rows) * w * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const Layout L = carve(n, w);
  if (ws_bytes <= L.temp || reinterpret_cast<uintptr_t>(ws_p) % ALIGN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ws = static_cast<char*>(ws_p);
  auto* keys0 = reinterpret_cast<uint32_t*>(ws + L.keys0);
  auto* pos0 = reinterpret_cast<int*>(ws + L.pos0);
  const int ni = static_cast<int>(n);

  prep_keys<<<(ni + 255) / 256, 256, 0, s>>>(
      static_cast<const long long*>(ids_p), keys0, pos0, ni, num_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cub::DoubleBuffer<uint32_t> keys(keys0,
                                   reinterpret_cast<uint32_t*>(ws + L.keys1));
  cub::DoubleBuffer<int> pos(pos0, reinterpret_cast<int*>(ws + L.pos1));
  // CUB refuses storage smaller than it needs
  size_t temp_bytes = ws_bytes - L.temp;
  err = cub::DeviceRadixSort::SortPairs(ws + L.temp, temp_bytes, keys, pos, ni,
                                        0, end_bit, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_chunks = (ni + CHUNK - 1) / CHUNK;
  const auto rows = static_cast<uint32_t>(num_rows);
  const auto* sk = keys.Current();
  const auto* sp = pos.Current();
  const auto* g = static_cast<const float*>(g_p);
  auto* head = reinterpret_cast<float*>(ws + L.head);
  auto* tail = reinterpret_cast<float*>(ws + L.tail);
  return static_cast<int>(sum_sorted(s, sk, sp, g, out, head, tail, ni, w,
                                     rows, n_chunks));
}

// Bytes of the workspace `segment_sum_sparse` needs for n ids of width w
// sorted over end_bit bits, into *bytes: the dense mode's parts, the run
// numbers' sums, and the larger of the sort's and the scan's storage.
extern "C" int segment_sum_sparse_workspace_bytes(long long n, int w,
                                                  int end_bit,
                                                  unsigned long long* bytes) {
  *bytes = 0;
  if (bad_shape(n, w, end_bit)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  size_t sort_bytes = 0, scan_bytes = 0;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> pos(nullptr, nullptr);
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, sort_bytes, keys, pos, static_cast<int>(n), 0, end_bit);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceScan::InclusiveSum(nullptr, scan_bytes,
                                      static_cast<const int*>(nullptr),
                                      static_cast<int*>(nullptr),
                                      static_cast<int>(n));
  *bytes = carve(n, w, true).temp + (sort_bytes > scan_bytes ? sort_bytes
                                                             : scan_bytes);
  return static_cast<int>(err);
}

// The sparse mode. ids: [n] int64; g: [m, w] float32, the gradient rows;
// grad_rows: [n] int32, id i's gradient is row grad_rows[i] of g;
// uniq: [n] int64, the distinct ids in [0, num_rows) ascending, then
// num_rows; rows: [n, w] float32, each distinct id's sum at its place
// (places from the count on are not written); count: one int64, the
// number of distinct ids. workspace: ws_bytes >=
// segment_sum_sparse_workspace_bytes(n, w, end_bit), 256-byte aligned.
// Launches on `stream`, does not synchronise, never reads the count back.
extern "C" int segment_sum_sparse(const void* ids_p, const void* g_p,
                                  const void* grad_rows_p, void* uniq_p,
                                  void* rows_p, void* count_p, void* ws_p,
                                  unsigned long long ws_bytes, long long n,
                                  int w, long long num_rows, int end_bit,
                                  void* stream) {
  if (bad_shape(n, w, end_bit) || num_rows <= 0 || num_rows > MAX_ROWS ||
      (num_rows >> end_bit) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* count = static_cast<long long*>(count_p);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(long long), s));
  const Layout L = carve(n, w, true);
  if (ws_bytes <= L.temp || reinterpret_cast<uintptr_t>(ws_p) % ALIGN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ws = static_cast<char*>(ws_p);
  auto* keys0 = reinterpret_cast<uint32_t*>(ws + L.keys0);
  auto* pos0 = reinterpret_cast<int*>(ws + L.pos0);
  const int ni = static_cast<int>(n);
  const unsigned flat = (ni + 255) / 256;

  prep_keys_sparse<<<flat, 256, 0, s>>>(
      static_cast<const long long*>(ids_p),
      static_cast<const int*>(grad_rows_p), keys0, pos0, ni, num_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cub::DoubleBuffer<uint32_t> keys(keys0,
                                   reinterpret_cast<uint32_t*>(ws + L.keys1));
  cub::DoubleBuffer<int> pos(pos0, reinterpret_cast<int*>(ws + L.pos1));
  size_t temp_bytes = ws_bytes - L.temp;
  err = cub::DeviceRadixSort::SortPairs(ws + L.temp, temp_bytes, keys, pos, ni,
                                        0, end_bit, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto rows = static_cast<uint32_t>(num_rows);
  const uint32_t* sk = keys.Current();
  // the sort's spare key buffer holds the flags, then the run numbers
  uint32_t* rk = keys.Alternate();
  auto* flags = reinterpret_cast<int*>(rk);
  auto* incl = reinterpret_cast<int*>(ws + L.incl);
  run_starts<<<flat, 256, 0, s>>>(sk, flags, ni, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  temp_bytes = ws_bytes - L.temp;
  err = cub::DeviceScan::InclusiveSum(ws + L.temp, temp_bytes, flags, incl,
                                      ni, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_runs<<<flat, 256, 0, s>>>(sk, incl, rk,
                                    static_cast<long long*>(uniq_p), count,
                                    ni, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the run numbers are below n; n itself marks the ids out of range
  return static_cast<int>(sum_sorted(
      s, rk, pos.Current(), static_cast<const float*>(g_p),
      static_cast<float*>(rows_p), reinterpret_cast<float*>(ws + L.head),
      reinterpret_cast<float*>(ws + L.tail), ni, w,
      static_cast<uint32_t>(ni), (ni + CHUNK - 1) / CHUNK));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
