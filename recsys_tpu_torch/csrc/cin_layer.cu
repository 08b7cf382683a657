// One CIN layer forward for Hopper (sm_90a):
//
//     y[n, h] = relu( sum_{p<F0, q<Fk} x0[n, p] * xk[n, q] * W[p*Fk + q, h] + b[h] )
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_cin.py:_fwd_kernel, launched
// by _fwd_impl. The Pallas kernel built the outer-product tile
// z[n, p*Fk+q] in VMEM by two 0/1 selector matmuls (x0 @ S^T, xk @ R^T) and
// fed it to the MXU. Those selector matmuls only move data, so this kernel
// indexes z directly: z is formed in registers and never touches memory.
//
// What bounds it on the H100: the float32 arithmetic on the CUDA cores,
// and next to it the shared-memory pipe that feeds them W. Per row it does
// F0*Fk*H multiply-adds (39*39*20 = 30,420 at the first xDeepFM layer)
// against 4*(F0 + Fk + H) bytes of row traffic; at N = 65,536 the three
// xDeepFM layers are 0.085 ms of FMAs at the card's 67 TFLOP/s. Float32
// FMAs only: no TF32, no tensor cores, no atomics.
//
// The first design (one thread per row) lost the FMA rate three ways: its
// inner loop issued one shared load (one W float4, or one W value) for
// every 1 to 4 FMAs; every block of 128 rows staged all of W again, in
// chunks with two barriers each; and the row tiles were copied one float at
// a time, with an integer division per float. This design:
//
//   - Register blocking. A block is 256 threads. KP = 8 lanes of a warp
//     share a group of R rows (R = 4 up to H = 24, else 2) and split the
//     p values among them (lane j takes p = j, j + 8, ...); each lane keeps
//     R x H accumulators and, for a pass of PL = 5 of its p values, the x0
//     values of its rows in registers. Per q it reads the R values
//     xk[row, q] once and, per p of the pass, ceil(H/4) float4s of W,
//     forming z in a register and doing R FMAs per W value: PL*R*H FMAs for
//     R + PL*ceil(H/4) shared loads (400 for 29 at H = 20, 200 for 19 at
//     H = 10). The q loop is unrolled by 2. The 8 lanes' partial sums are
//     added by a reduce-scatter over warp shuffles (3 rounds, fixed order),
//     which also leaves each lane an eighth of the group's outputs to
//     store: one writer per output.
//   - W staged once per block. Each (p, q) row of W is padded to HP (H
//     rounded up to 4, zeros in the pad), and each p's rows to a stride
//     whose count of float4s is odd, so that the 8 lanes' float4 reads (8
//     consecutive p) fall into distinct banks: one 128-byte wavefront a
//     load. The grid is at most one wave (SMs x resident blocks) and each
//     block walks row tiles, so W comes from L2 once per block. A W too
//     large to sit beside the tiles (such as F0 = Fk = 39 at H = 32) is
//     staged in chunks of p, again for every tile: whole steps of KP values
//     of p where a step fits, else fewer (lanes past the chunk idle); and
//     where even one value of p does not fit beside a tile of GROUPS x R
//     rows, the tile has fewer rows (gs of the row groups in use, gs halved
//     from GROUPS).
//   - Tiles by 16-byte copies. A tile's rows are contiguous in device
//     memory and the kernel reads them in that layout, so x0 and xk come in
//     as flat runs by cp.async (16 bytes when the base is 16-byte aligned),
//     with no per-element index arithmetic. Two tile buffers: the next
//     tile's copy runs under this tile's FMAs (one buffer, and no overlap,
//     where F0 + Fk is too large for two).
//   The ragged last tile is masked, not padded in device memory; offsets
//   into the row arrays are 64-bit.
//
// What holds it below the FMA rate: the W loads. Each float4 of W feeds R
// FMAs per lane, and R is capped by the registers (R x H accumulators plus
// R x PL values of x0). Fewer rows a lane (2 or 3) or more lanes sharing a
// float4 across the columns (16 distinct addresses, two wavefronts a load)
// ran slower on the card; PERF.md keeps the numbers.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libcin_layer.so cin_layer.cu
// C entry point cin_layer_fwd returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // threads per block
constexpr int KP = 8;                // lanes splitting p within a row group
constexpr int GROUPS = THREADS / KP; // row groups per block
constexpr int PL = 5;                // p values per lane held per pass
constexpr int QU = 2;                // q values per trip of the inner loop
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may use

// The tile of one lane and its row group, by H: R rows of H columns (HP:
// padded to a whole number of float4s); a block's tile has GROUPS x R rows
// at most.
template <int H>
struct Tile {
  static constexpr int HP = (H + 3) / 4 * 4;
  static constexpr int R = H > 24 ? 2 : 4;
  static constexpr int V = (R * H + KP - 1) / KP * KP;  // accumulators
  // blocks an SM must hold by registers: 16 warps up to 48 accumulators a
  // lane, else 8
  static constexpr int MIN_BLOCKS = R * H <= 48 ? 2 : 1;
};

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// Floats between consecutive p in the staged W: fk rows of hp floats (a
// multiple of 4), rounded up to an odd number of float4s.
__host__ __device__ inline int p_stride(int fk, int hp) {
  const int f4 = fk * hp / 4;
  return 4 * (f4 | 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cnt contiguous floats from src to dst by cp.async: 16-byte copies when
// both ends allow them, the tail (or everything, if not) 4 bytes at a time.
__device__ __forceinline__ void copy_run(float* dst, const float* src,
                                         int cnt, bool vec, int t) {
  int done = 0;
  if (vec) {
    const int n4 = cnt >> 2;
    for (int e = t; e < n4; e += THREADS) cp_async16(dst + 4 * e, src + 4 * e);
    done = n4 << 2;
  }
  for (int e = done + t; e < cnt; e += THREADS) cp_async4(dst + e, src + e);
}

// W rows of p in [p0, p1) into w_s [p - p0][q][HP] (p stride ps), zeros in
// the pad; by cp.async, so the caller commits and waits.
template <int H>
__device__ __forceinline__ void stage_w(float* w_s, const float* __restrict__ w,
                                        int p0, int p1, int fk, int ps,
                                        bool vec, int t) {
  constexpr int HP = Tile<H>::HP;
  if (vec && HP == H) {  // rows of W are whole float4s, unpadded
    for (int p = p0; p < p1; ++p) {
      const float* src = w + static_cast<long long>(p) * fk * H;
      copy_run(w_s + (p - p0) * ps, src, fk * H, true, t);
    }
    return;
  }
  for (int p = p0; p < p1; ++p) {
    const float* src = w + static_cast<long long>(p) * fk * H;
    float* dst = w_s + (p - p0) * ps;
    for (int e = t; e < fk * HP; e += THREADS) {
      const int q = e / HP;  // HP is a constant: no division instruction
      const int h = e - q * HP;
      if (h < H) {
        cp_async4(dst + e, src + q * H + h);
      } else {
        dst[e] = 0.0f;
      }
    }
  }
}

// v[0, N) of the 8 lanes of a row group: lanes whose `mask` bit is set keep
// the upper half, the others the lower half, each adding its partner's
// copy; the sums' order is fixed by the lane numbers.
template <int N>
__device__ __forceinline__ void fold(float* v, int mask, int lane) {
  const bool hi = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = hi ? v[i] : v[i + N / 2];
    const float keep = hi ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS, Tile<H>::MIN_BLOCKS)
cin_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
               const float* __restrict__ w, const float* __restrict__ b,
               float* __restrict__ y, int n, int f0, int fk, int chunk_p,
               int gs, int tiles, int bufs) {
  constexpr int HP = Tile<H>::HP;
  constexpr int R = Tile<H>::R;
  constexpr int V = Tile<H>::V;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int jp = lane & (KP - 1);                 // which p of each step
  const int g = (t >> 5) * (32 / KP) + lane / KP; // row group: rows g + gs*r
  const int gc = min(g, gs - 1);  // a group past the tile's gs computes row
                                  // group gs - 1 again and stores nothing
  const int tr = gs * R;          // rows of a tile
  const int x0_buf = align4(tr * f0);
  const int xk_buf = align4(tr * fk);
  float* x0_s = smem;                 // [bufs][tr * f0], flat as in memory
  float* xk_s = x0_s + bufs * x0_buf; // [bufs][tr * fk]
  float* w_s = xk_s + bufs * xk_buf;  // [chunk_p][ps]
  const int ps = p_stride(fk, HP);
  const bool one_chunk = chunk_p >= f0;
  const bool vec_w = (reinterpret_cast<size_t>(w) & 15) == 0;

  auto load_tile = [&](int tile, int buf) {
    const long long row0 = static_cast<long long>(tile) * tr;
    const int rows = static_cast<int>(min(static_cast<long long>(tr), n - row0));
    const float* x0_g = x0 + row0 * f0;
    const float* xk_g = xk + row0 * fk;
    copy_run(x0_s + buf * x0_buf, x0_g, rows * f0,
             (reinterpret_cast<size_t>(x0_g) & 15) == 0, t);
    copy_run(xk_s + buf * xk_buf, xk_g, rows * fk,
             (reinterpret_cast<size_t>(xk_g) & 15) == 0, t);
  };

  int tile = blockIdx.x;
  if (one_chunk) stage_w<H>(w_s, w, 0, f0, fk, ps, vec_w, t);
  if (tile < tiles) load_tile(tile, 0);
  cp_async_commit();

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int buf = it & (bufs - 1);
    const int next = tile + static_cast<int>(gridDim.x);
    if (bufs == 2 && next < tiles) {
      load_tile(next, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and, at it = 0, the whole W) landed
    const float* x0_t = x0_s + buf * x0_buf;
    const float* xk_t = xk_s + buf * xk_buf;

    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;

    for (int p0 = 0; p0 < f0; p0 += chunk_p) {
      const int p1 = min(p0 + chunk_p, f0);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk is consumed
        stage_w<H>(w_s, w, p0, p1, fk, ps, vec_w, t);
        cp_async_commit();
        cp_async_wait<0>();  // (also waits for the next tile's copy)
        __syncthreads();
      }
      for (int sp = p0; sp < p1; sp += PL * KP) {
        // this lane's p values of the pass: x0 of its rows in registers
        // (0 for a slot past the chunk), and their W rows
        float a[R][PL];
        int wo[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int p = sp + i * KP + jp;
          const bool live = p < p1;
          wo[i] = live ? (p - p0) * ps : 0;
#pragma unroll
          for (int r = 0; r < R; ++r)
            a[r][i] = live ? x0_t[(gc + gs * r) * f0 + p] : 0.0f;
        }
#pragma unroll QU
        for (int q = 0; q < fk; ++q) {
          float xv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) xv[r] = xk_t[(gc + gs * r) * fk + q];
#pragma unroll
          for (int i = 0; i < PL; ++i) {
            const float* wp = w_s + wo[i] + q * HP;
            float z[R];
#pragma unroll
            for (int r = 0; r < R; ++r) z[r] = a[r][i] * xv[r];
#pragma unroll
            for (int h4 = 0; h4 < HP; h4 += 4) {
              const float4 wv = *reinterpret_cast<const float4*>(wp + h4);
              const float wu[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (h4 + u < H) {
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    acc[r * H + h4 + u] = fmaf(z[r], wu[u], acc[r * H + h4 + u]);
                }
              }
            }
          }
        }
      }
    }

    // the 8 lanes' partial sums: reduce-scatter, then each lane stores its
    // eighth of the group's R x H outputs
    fold<V>(acc, 4, lane);
    fold<V / 2>(acc, 2, lane);
    fold<V / 4>(acc, 1, lane);
    const int off = ((jp >> 2) & 1) * (V / 2) + ((jp >> 1) & 1) * (V / 4) +
                    (jp & 1) * (V / 8);
    const long long row0 = static_cast<long long>(tile) * tr;
#pragma unroll
    for (int i = 0; i < V / KP; ++i) {
      const int e = off + i;
      const int r = e / H;
      const int h = e - r * H;
      const long long row = row0 + g + gs * r;
      if (r < R && g < gs && row < n)
        y[row * H + h] = fmaxf(acc[i] + b[h], 0.0f);
    }
    __syncthreads();  // buffer `buf` is free for tile it + bufs
    if (bufs == 1 && next < tiles) {
      load_tile(next, 0);
      cp_async_commit();
    }
  }
}

template <int H>
cudaError_t launch(const float* x0, const float* xk, const float* w,
                   const float* b, float* y, int n, int f0, int fk,
                   cudaStream_t stream) {
  constexpr int R = Tile<H>::R;
  const size_t p_bytes =
      sizeof(float) * static_cast<size_t>(p_stride(fk, Tile<H>::HP));
  auto tiles_of = [&](int gs, int bufs) {
    return sizeof(float) * bufs *
           (static_cast<size_t>(align4(gs * R * f0)) +
            static_cast<size_t>(align4(gs * R * fk)));
  };
  // Two tile buffers (the next tile's copy under this tile's FMAs) of
  // GROUPS x R rows beside a step of W (KP values of p); where that does not fit, give
  // up in this order: the second buffer, the step for one value of p, then
  // half the rows of a tile at a time.
  int bufs = 2, gs = GROUPS;
  int unit = f0 < KP ? f0 : KP;
  while (tiles_of(gs, bufs) + unit * p_bytes > static_cast<size_t>(SMEM_MAX)) {
    if (bufs == 2) {
      bufs = 1;
    } else if (unit > 1) {
      unit = 1;
    } else if (gs > 1) {
      gs /= 2;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const size_t tiles_bytes = tiles_of(gs, bufs);
  // as few chunks of p as fit beside the tiles, balanced; whole steps of KP
  // values where a step fits
  int chunk_p = static_cast<int>((SMEM_MAX - tiles_bytes) / p_bytes);
  if (chunk_p >= f0) {
    chunk_p = f0;
  } else if (chunk_p >= KP) {
    const int steps = (f0 + KP - 1) / KP;
    const int chunks = (steps + chunk_p / KP - 1) / (chunk_p / KP);
    chunk_p = KP * ((steps + chunks - 1) / chunks);
  } else {
    const int chunks = (f0 + chunk_p - 1) / chunk_p;
    chunk_p = (f0 + chunks - 1) / chunks;
  }
  const size_t smem = tiles_bytes + p_bytes * chunk_p;
  // once per device: the shared-memory ceiling, the SM count and the
  // shared memory an SM has
  static int sms[64] = {}, sm_smem[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(cin_fwd_kernel<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return err;
    int count = 0, bytes = 0;
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_smem[dev] = bytes;
    sms[dev] = count;
  }
  // blocks an SM holds: its shared memory (1 KB reserved a block) or the
  // register budget of __launch_bounds__, whichever is less
  int per_sm = sm_smem[dev] / static_cast<int>(smem + 1024);
  if (per_sm > Tile<H>::MIN_BLOCKS) per_sm = Tile<H>::MIN_BLOCKS;
  if (per_sm < 1) per_sm = 1;
  const int wave = sms[dev] * per_sm;
  const int tr = gs * R;
  const int tiles = static_cast<int>((static_cast<long long>(n) + tr - 1) / tr);
  // one wave: each block walks tiles; never more blocks than tiles
  const int grid = tiles < wave ? tiles : wave;
  cin_fwd_kernel<H><<<grid, THREADS, smem, stream>>>(x0, xk, w, b, y, n, f0,
                                                     fk, chunk_p, gs, tiles,
                                                     bufs);
  return cudaGetLastError();
}

}  // namespace

#define CIN_CASE(H) \
  case H:           \
    return static_cast<int>(launch<H>(x0, xk, w, b, y, n, f0, fk, s));

// x0 [n, f0], xk [n, fk], w [f0*fk, h], b [h] in; y [n, h] out. Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int cin_layer_fwd(const void* x0_p, const void* xk_p,
                             const void* w_p, const void* b_p, void* y_p,
                             int n, int f0, int fk, int h, void* stream) {
  const float* x0 = static_cast<const float*>(x0_p);
  const float* xk = static_cast<const float*>(xk_p);
  const float* w = static_cast<const float*>(w_p);
  const float* b = static_cast<const float*>(b_p);
  float* y = static_cast<float*>(y_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f0 <= 0 || fk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (h) {
    CIN_CASE(1) CIN_CASE(2) CIN_CASE(3) CIN_CASE(4)
    CIN_CASE(5) CIN_CASE(6) CIN_CASE(7) CIN_CASE(8)
    CIN_CASE(9) CIN_CASE(10) CIN_CASE(11) CIN_CASE(12)
    CIN_CASE(13) CIN_CASE(14) CIN_CASE(15) CIN_CASE(16)
    CIN_CASE(17) CIN_CASE(18) CIN_CASE(19) CIN_CASE(20)
    CIN_CASE(21) CIN_CASE(22) CIN_CASE(23) CIN_CASE(24)
    CIN_CASE(25) CIN_CASE(26) CIN_CASE(27) CIN_CASE(28)
    CIN_CASE(29) CIN_CASE(30) CIN_CASE(31) CIN_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
