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
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
// The C entry points return the cudaError_t of their calls.

#include <cstdint>

#include <cub/device/device_radix_sort.cuh>
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
  size_t keys0, keys1, pos0, pos1, head, tail, temp;
};

Layout carve(long long n, int w) {
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
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  segment_carry<<<dim3(blocks, (w + 31) / 32), WARPS * 32, 0, s>>>(
      sk, head, tail, out, w, rows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
