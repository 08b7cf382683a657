// One CIN layer backward for Hopper (sm_90a). With the forward
//
//     y[n, h] = relu( sum_{p<F0, q<Fk} x0[n, p] * xk[n, q] * W[p*Fk + q, h] + b[h] )
//
// and dy the gradient of y, it computes (z[n, p*Fk+q] = x0[n, p] * xk[n, q])
//
//     g[n, h]   = dy[n, h] * (y[n, h] > 0)
//     dz[n, j]  = sum_h g[n, h] * W[j, h]
//     dx0[n, p] = sum_q xk[n, q] * dz[n, p*Fk+q]
//     dxk[n, q] = sum_p x0[n, p] * dz[n, p*Fk+q]
//     dW[j, h]  = sum_n z[n, j] * g[n, h]          db[h] = sum_n g[n, h]
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_cin.py:_bwd_kernel, launched
// by _bwd_impl. The Pallas kernel expanded x0 and xk into z-columns with 0/1
// selector matmuls and carried dW/db across its sequential grid in a
// resident output block. On the H100 the selector matmuls are plain
// indexing, and blocks run in parallel in no order, so dW is summed in two
// passes.
//
// What bounds it on the H100: the float32 arithmetic on the CUDA cores. Per
// row, dz costs F0*Fk*H multiply-adds and dW another F0*Fk*H (39*39*20 =
// 30,420 each at the first xDeepFM layer) against 4*(F0 + Fk + 2H) bytes of
// row traffic; at N = 65,536 the first layer is 0.127 ms of FMAs at the
// card's 67 TFLOP/s. Float32 FMAs only: no TF32, no tensor cores, and no
// float atomics.
//
// The first design (one thread per row) lost the FMA rate three ways: each
// dz was a chain of H dependent FMAs; each FMA waited on a shared-memory
// read of W, and every (p, q) did a read-modify-write of dxk in shared
// memory; and 82 KB of row tiles a block left 8 warps per SM. Its dW
// partials were summed by one serial thread per output. This design, four
// kernels on one stream:
//
//   1. cin_bwd_wt: W rearranged into wt [pass][p][h][8 q] (zero beyond Fk),
//      so that the rows pass stages a slice with contiguous 16-byte copies.
//   2. cin_bwd_rows (dz, dx0, dxk), register-blocked like an SGEMM
//      micro-tile. Two lanes share a set of RT = 2 rows; each lane owns a
//      tile of 4 q values (a pass covers a pair's 8 q; a last pass with
//      one tile gives each lane one row of it). Per (p, h) a lane reads one
//      float4 of W and does 8 independent FMAs with g[row, h] held in
//      registers: no serial chain over H. dxk accumulates in
//      registers across the p loop and is written once a pass. dx0[n, p] is
//      the two lanes' partial sums added with one warp shuffle (a + b gives
//      the same bits in either lane), accumulated over the passes in order
//      in a transposed shared tile, and written once. The W slices come in
//      by cp.async, double buffered, so the next slice loads while this one
//      is used; the x0 tile comes in by cp.async too. 128 rows and 53 KB of
//      shared memory a block (at H = 20): 4 blocks, 16 warps, per SM, and
//      the 512 blocks of N = 65,536 are one wave.
//   3. cin_bwd_dw (dW = z^T g, db), a split-K GEMM. A thread owns 4 columns
//      of z (one p, 4 q) x H outputs in registers; the bias is one more
//      tile that reads a constant column (z = 1) of the staged tiles. Per
//      row a thread forms its 4 z values from one x0 and one float4 of xk,
//      and reads g as float4 broadcasts: 4H FMAs per H/4 + 2 shared reads.
//      Row tiles of x0, xk, y and dy come in by cp.async, double buffered;
//      every tile runs a fixed 64 rows (g = 0 past the group's end). The
//      caller picks the row groups (at large N, 132 or more: every SM has
//      one). Each block writes its group's partial sums as float4s, so a
//      warp's stores are contiguous.
//   4. cin_bwd_reduce: 32 partial-sum slots x 8 slices of groups a block;
//      each thread sums its slice in group order, then one thread sums the
//      8 slices in order, so the result is fixed for a shape and bitwise
//      repeatable.
//   Every output is written once; the ragged last tile is masked, not
//   padded in device memory; offsets into the row arrays are 64-bit.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libcin_backward.so cin_backward.cu
// The C entry point cin_layer_bwd returns the cudaError_t of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int QT = 4;                 // q values per lane tile: one float4
constexpr int PAIR = 2;               // lanes sharing a row set (rows pass)
constexpr int RT = 2;                 // rows per lane (rows pass)
constexpr int WQ = PAIR * QT;         // q values of one staged W row
constexpr int ROWS_THREADS = 128;     // threads per block, rows pass
constexpr int ROWS_MIN_BLOCKS = 4;    // blocks per SM, rows pass
constexpr int W_STAGE_BYTES = 8192;   // one staged slice of W, at most
constexpr int DW_TR = 64;             // rows per staged tile, dW pass
constexpr int RED_SLICES = 8;         // group slices per output, reduce
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use

template <int H>
__host__ __device__ constexpr int dw_max_threads() {
  return H <= 20 ? 512 : 256;
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

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// Shared floats of the rows pass: x0 and dx0 tiles [f0][br + 1], then two
// W slices of pc * H * PAIR * QT floats.
__host__ __device__ inline int rows_tiles_floats(int f0, int br) {
  return align4(2 * f0 * (br + 1));
}

// W [f0*fk, H] -> wt [passes][f0][H][PAIR*QT]: pass i holds q in
// [i*PAIR*QT, (i+1)*PAIR*QT), zero beyond fk, so that the rows pass stages
// each slice with contiguous 16-byte copies.
__global__ void cin_bwd_wt(const float* __restrict__ w, float* __restrict__ wt,
                           int f0, int fk, int h, int passes) {
  const long long total = static_cast<long long>(passes) * f0 * h * WQ;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const int ql = static_cast<int>(e % WQ);
  const long long r = e / WQ;
  const int hh = static_cast<int>(r % h);
  const long long ip = r / h;  // i * f0 + p
  const int p = static_cast<int>(ip % f0);
  const int q = static_cast<int>(ip / f0) * WQ + ql;
  wt[e] = q < fk ? w[(static_cast<long long>(p) * fk + q) * h + hh] : 0.0f;
}

template <int H>
__global__ void __launch_bounds__(ROWS_THREADS, ROWS_MIN_BLOCKS)
cin_bwd_rows(const float* __restrict__ x0, const float* __restrict__ xk,
             const float* __restrict__ wt, const float* __restrict__ y,
             const float* __restrict__ dy, float* __restrict__ dx0,
             float* __restrict__ dxk, int n, int f0, int fk, int pc) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int sets = nt / PAIR;  // row sets; row r of a set is r * sets + rs
  const int br = sets * RT;
  const int bs = br + 1;       // odd stride: transposed tiles conflict-free
  float* x0_s = smem;          // [f0][bs]
  float* dx0_s = x0_s + f0 * bs;
  float* w_s = smem + rows_tiles_floats(f0, br);  // [2][pc][H][WQ]
  const int wst = pc * H * WQ;

  const int j = t & (PAIR - 1);  // which q tile of the pair
  const int rs = t / PAIR;
  const long long row0 = static_cast<long long>(blockIdx.x) * br;
  const int rows = static_cast<int>(min(static_cast<long long>(br), n - row0));
  const int nqt = (fk + QT - 1) / QT;
  const int passes = (nqt + PAIR - 1) / PAIR;
  const int chunks = (f0 + pc - 1) / pc;
  const int stages = passes * chunks;

  // W slice of stage s (pass i: q in [i*WQ, i*WQ + WQ); chunk c of p) into
  // buffer s & 1: one contiguous run of wt
  auto stage = [&](int s) {
    const int i = s / chunks;
    const int p0 = (s - i * chunks) * pc;
    const int np = min(pc, f0 - p0);
    float* dst = w_s + (s & 1) * wst;
    const float* src = wt + (static_cast<long long>(i) * f0 + p0) * H * WQ;
    for (int e = t * 4; e < np * H * WQ; e += nt * 4) cp_async16(dst + e, src + e);
    cp_async_commit();
  };

  // the x0 tile, transposed, by cp.async in stage 0's group: every load is
  // in flight at once
  const float* x0_g = x0 + row0 * f0;
  for (int e = t; e < br * f0; e += nt) {
    const int r = e / f0;
    float* d = x0_s + (e - r * f0) * bs + r;
    if (r < rows) {
      cp_async4(d, x0_g + e);
    } else {
      *d = 0.0f;
    }
  }
  stage(0);
  for (int e = t; e < f0 * bs; e += nt) dx0_s[e] = 0.0f;

  // g of this thread's rows: loads from a row in range, issued together
  float g[RT][H];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int lr = r * sets + rs;
    const long long base = (row0 + min(lr, rows - 1)) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float yv = y[base + h];
      const float dv = dy[base + h];
      g[r][h] = lr < rows && yv > 0.0f ? dv : 0.0f;
    }
  }

  float xkr[RT][QT], dxk_acc[RT][QT];
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and, at s = 0, the tiles) landed
    const int i = s / chunks;
    const int c = s - i * chunks;
    // a last pass with one q tile is "solo": both lanes take that tile,
    // lane j the set's row j, so that no lane computes a tile of zeros
    const bool solo = i * PAIR + 1 >= nqt;
    const int qb = (i * PAIR + (solo ? 0 : j)) * QT;  // this lane's first q
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int lr = (solo ? j : r) * sets + rs;
        const float* xk_r = xk + (row0 + min(lr, rows - 1)) * fk;
#pragma unroll
        for (int k = 0; k < QT; ++k) {
          const int q = qb + k;
          const float v = xk_r[min(q, fk - 1)];
          xkr[r][k] = lr < rows && q < fk ? v : 0.0f;
          dxk_acc[r][k] = 0.0f;
        }
      }
      if (solo && j == 1) {  // row 1's g into slot 0: g is not read again
#pragma unroll
        for (int h = 0; h < H; ++h) g[0][h] = g[1][h];
      }
    }
    const int p0 = c * pc;
    const int np = min(pc, f0 - p0);
    if (solo) {
      const float* ws = w_s + (s & 1) * wst;
      for (int pl = 0; pl < np; ++pl) {
        const int slot = (p0 + pl) * bs + j * sets + rs;
        const float* wp = ws + pl * H * WQ;
        float dz[QT] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 wv = *reinterpret_cast<const float4*>(wp + h * WQ);
          dz[0] = fmaf(g[0][h], wv.x, dz[0]);
          dz[1] = fmaf(g[0][h], wv.y, dz[1]);
          dz[2] = fmaf(g[0][h], wv.z, dz[2]);
          dz[3] = fmaf(g[0][h], wv.w, dz[3]);
        }
        const float a = x0_s[slot];
        float d0 = xkr[0][0] * dz[0];
#pragma unroll
        for (int k = 1; k < QT; ++k) d0 = fmaf(xkr[0][k], dz[k], d0);
#pragma unroll
        for (int k = 0; k < QT; ++k)
          dxk_acc[0][k] = fmaf(a, dz[k], dxk_acc[0][k]);
        dx0_s[slot] += d0;
      }
    }
    const float* ws = w_s + (s & 1) * wst + j * QT;
    for (int pl = 0; pl < (solo ? 0 : np); ++pl) {
      const int p = p0 + pl;
      float dz[RT][QT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int k = 0; k < QT; ++k) dz[r][k] = 0.0f;
      const float* wp = ws + pl * H * WQ;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 wv = *reinterpret_cast<const float4*>(wp + h * WQ);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          dz[r][0] = fmaf(g[r][h], wv.x, dz[r][0]);
          dz[r][1] = fmaf(g[r][h], wv.y, dz[r][1]);
          dz[r][2] = fmaf(g[r][h], wv.z, dz[r][2]);
          dz[r][3] = fmaf(g[r][h], wv.w, dz[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int slot = p * bs + r * sets + rs;
        const float a = x0_s[slot];
        float d0 = xkr[r][0] * dz[r][0];
#pragma unroll
        for (int k = 1; k < QT; ++k) d0 = fmaf(xkr[r][k], dz[r][k], d0);
#pragma unroll
        for (int k = 0; k < QT; ++k)
          dxk_acc[r][k] = fmaf(a, dz[r][k], dxk_acc[r][k]);
        d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
        if (j == 0) dx0_s[slot] += d0;
      }
    }
    if (c == chunks - 1) {
#pragma unroll
      for (int r = 0; r < (solo ? 1 : RT); ++r) {
        const int lr = (solo ? j : r) * sets + rs;
        if (lr < rows) {
#pragma unroll
          for (int k = 0; k < QT; ++k)
            if (qb + k < fk) dxk[(row0 + lr) * fk + qb + k] = dxk_acc[r][k];
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for stage s + 2
  }
  float* dx0_g = dx0 + row0 * f0;
  for (int e = t; e < rows * f0; e += nt) {
    const int r = e / f0;
    dx0_g[e] = dx0_s[(e - r * f0) * bs + r];
  }
}

// Shared floats of one staged row tile of the dW pass: xk [tr][fkp + 4]
// (its last 4 columns hold 1, 0, 0, 0), g and y [tr][HP], x0 [tr][f0 + 1]
// (its last column holds 1): the bias tile reads z = 1 through the same
// code as every other tile.
__host__ __device__ inline int dw_tile_floats(int tr, int f0, int fkp,
                                              int hp) {
  return align4(tr * (fkp + 4 + 2 * hp + f0 + 1));
}

template <int H>
__global__ void __launch_bounds__(dw_max_threads<H>())
cin_bwd_dw(const float* __restrict__ x0, const float* __restrict__ xk,
           const float* __restrict__ y, const float* __restrict__ dy,
           float* __restrict__ part, int n, int f0, int fk,
           int rows_per_group, int tr) {
  constexpr int HP = (H + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int nqt = (fk + QT - 1) / QT;
  const int fkp = nqt * QT;
  const int buf = dw_tile_floats(tr, f0, fkp, HP);
  const int tiles = f0 * nqt + 1;  // the last: the bias
  const int c = blockIdx.x * nt + t;
  const bool live = c < tiles;
  const int cc = min(c, tiles - 1);
  // the bias tile reads x0's column f0 and xk's tile nqt (z = 1, 0, 0, 0)
  const bool bias = cc == tiles - 1;
  const int p = bias ? f0 : cc / nqt;
  const int qt = bias ? nqt : cc - cc / nqt * nqt;
  const int xs = fkp + 4;  // row strides of the staged xk and x0 tiles
  const int x0s = f0 + 1;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_group;
  const long long r1 = min(r0 + rows_per_group, static_cast<long long>(n));
  const int ntiles = r1 > r0 ? static_cast<int>((r1 - r0 + tr - 1) / tr) : 0;

  // zero both buffers once: the padding (q >= fk, h >= H) stays zero; then
  // the constant columns of the bias tile
  for (int e = t; e < 2 * buf; e += nt) smem[e] = 0.0f;
  __syncthreads();
  for (int e = t; e < 2 * tr; e += nt) {
    float* xk_s = smem + (e / tr) * buf;
    const int r = e - e / tr * tr;
    xk_s[r * xs + fkp] = 1.0f;
    (xk_s + tr * (xs + 2 * HP))[r * x0s + f0] = 1.0f;
  }
  __syncthreads();

  auto load = [&](int k) {
    const long long row = r0 + static_cast<long long>(k) * tr;
    const int cnt = static_cast<int>(min(static_cast<long long>(tr), r1 - row));
    float* xk_s = smem + (k & 1) * buf;
    float* g_s = xk_s + tr * xs;
    float* y_s = g_s + tr * HP;
    float* x0_s = y_s + tr * HP;
    for (int e = t; e < cnt * f0; e += nt) {
      const int r = e / f0;
      cp_async4(x0_s + r * x0s + (e - r * f0), x0 + row * f0 + e);
    }
    for (int e = t; e < cnt * fk; e += nt) {
      const int r = e / fk;
      cp_async4(xk_s + r * xs + (e - r * fk), xk + row * fk + e);
    }
    for (int e = t; e < cnt * H; e += nt) {
      const int r = e / H;
      const int o = r * HP + (e - r * H);
      cp_async4(g_s + o, dy + row * H + e);
      cp_async4(y_s + o, y + row * H + e);
    }
    cp_async_commit();
  };

  float acc[QT][H];
#pragma unroll
  for (int k = 0; k < QT; ++k)
#pragma unroll
    for (int h = 0; h < H; ++h) acc[k][h] = 0.0f;

  if (ntiles > 0) load(0);
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) {
      load(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k landed
    const long long row = r0 + static_cast<long long>(k) * tr;
    const int cnt = static_cast<int>(min(static_cast<long long>(tr), r1 - row));
    const float* xk_s = smem + (k & 1) * buf;
    float* g_s = const_cast<float*>(xk_s) + tr * xs;
    const float* y_s = g_s + tr * HP;
    const float* x0_s = y_s + tr * HP;
    // g = dy * (y > 0) in place; rows past the group's end get g = 0, so
    // that every tile runs the same tr rows
    for (int e = t; e < tr * H; e += nt) {
      const int r = e / H;
      const int o = r * HP + (e - r * H);
      if (r >= cnt || !(y_s[o] > 0.0f)) g_s[o] = 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < tr; ++r) {
      const float a = x0_s[r * x0s + p];
      const float4 xv =
          *reinterpret_cast<const float4*>(xk_s + r * xs + qt * QT);
      const float z[QT] = {a * xv.x, a * xv.y, a * xv.z, a * xv.w};
      const float* g_r = g_s + r * HP;
#pragma unroll
      for (int h4 = 0; h4 < HP; h4 += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g_r + h4);
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (h4 + u < H) {
#pragma unroll
            for (int q = 0; q < QT; ++q)
              acc[q][h4 + u] = fmaf(z[q], gg[u], acc[q][h4 + u]);
          }
        }
      }
    }
    __syncthreads();  // buffer k & 1 is free for tile k + 2
  }
  // partial sums [group][h][tile][4], one float4 a store: a warp's stores
  // are contiguous (the reduce maps them back to dW's layout)
  if (live) {
    float4* out = reinterpret_cast<float4*>(part) +
                  static_cast<long long>(blockIdx.y) * H * tiles;
#pragma unroll
    for (int h = 0; h < H; ++h)
      out[static_cast<long long>(h) * tiles + c] =
          make_float4(acc[0][h], acc[1][h], acc[2][h], acc[3][h]);
  }
}

// dW and db from the groups' partial sums [group][h][tile][4]: 32 slots a
// block, group slice s of RED_SLICES summed in group order by one thread,
// then the slices in order; a slot that holds a column of z (or the bias)
// is written to dw[p*fk + q, h] (or db[h]).
__global__ void __launch_bounds__(32 * RED_SLICES)
cin_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
               float* __restrict__ db, int groups, int f0, int fk, int h) {
  __shared__ float red[RED_SLICES][33];
  const int nqt = (fk + QT - 1) / QT;
  const int tiles = f0 * nqt + 1;
  const int slots = tiles * QT;  // per h
  const long long per_group = static_cast<long long>(slots) * h;
  const int ol = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const long long o = static_cast<long long>(blockIdx.x) * 32 + ol;
  float acc = 0.0f;
  if (o < per_group)
    for (int gr = s; gr < groups; gr += RED_SLICES)
      acc += part[gr * per_group + o];
  red[s][ol] = acc;
  __syncthreads();
  if (s == 0 && o < per_group) {
    float v = red[0][ol];
#pragma unroll
    for (int k = 1; k < RED_SLICES; ++k) v += red[k][ol];
    const int hh = static_cast<int>(o / slots);
    const int c = static_cast<int>(o - static_cast<long long>(hh) * slots) / QT;
    const int k = static_cast<int>(o % QT);
    if (c == tiles - 1) {
      if (k == 0) db[hh] = v;
    } else {
      const int q = (c % nqt) * QT + k;
      if (q < fk) dw[(static_cast<long long>(c / nqt) * fk + q) * h + hh] = v;
    }
  }
}

template <int H>
cudaError_t launch(const float* x0, const float* xk, const float* w,
                   const float* y, const float* dy, float* dx0, float* dxk,
                   float* part, float* wt, float* dw, float* db, int n, int f0,
                   int fk, int groups, int rows_per_group,
                   cudaStream_t stream) {
  // Raise the dynamic shared-memory ceiling once per device, outside any
  // CUDA-graph capture (the first call of a shape is a warm-up call).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(cin_bwd_rows<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cin_bwd_dw<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cin_bwd_rows<H>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }

  // rows pass: W slices of at most W_STAGE_BYTES, chunks of p balanced
  int pc = W_STAGE_BYTES / (H * WQ * 4);
  if (pc < 1) pc = 1;
  const int chunks = (f0 + pc - 1) / pc;
  pc = (f0 + chunks - 1) / chunks;
  int nt = ROWS_THREADS;
  size_t rows_smem = 0;
  for (; nt >= 32; nt /= 2) {
    const int br = nt / PAIR * RT;
    rows_smem = sizeof(float) * (static_cast<size_t>(rows_tiles_floats(f0, br)) +
                                 2 * static_cast<size_t>(pc) * H * WQ);
    if (rows_smem <= SMEM_MAX) break;
  }
  if (nt < 32) return cudaErrorInvalidValue;
  const int br = nt / PAIR * RT;
  const int passes = ((fk + QT - 1) / QT + PAIR - 1) / PAIR;
  const long long wt_floats = static_cast<long long>(passes) * f0 * H * WQ;
  cin_bwd_wt<<<static_cast<unsigned>((wt_floats + 255) / 256), 256, 0,
               stream>>>(w, wt, f0, fk, H, passes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = static_cast<unsigned>((n + br - 1) / br);
  cin_bwd_rows<H><<<row_blocks, nt, rows_smem, stream>>>(
      x0, xk, wt, y, dy, dx0, dxk, n, f0, fk, pc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dW pass: column tiles spread over as few blocks as the register budget
  // allows, whole warps
  constexpr int HP = (H + 3) / 4 * 4;
  const int fkp = (fk + QT - 1) / QT * QT;
  const int tiles = f0 * (fkp / QT) + 1;
  const int col_blocks =
      (tiles + dw_max_threads<H>() - 1) / dw_max_threads<H>();
  const int dw_threads = ((tiles + col_blocks - 1) / col_blocks + 31) / 32 * 32;
  int tr = DW_TR;
  while (tr > 1 && 2 * sizeof(float) *
                           static_cast<size_t>(dw_tile_floats(tr, f0, fkp, HP)) >
                       SMEM_MAX)
    tr /= 2;
  const size_t dw_smem =
      2 * sizeof(float) * static_cast<size_t>(dw_tile_floats(tr, f0, fkp, HP));
  if (dw_smem > SMEM_MAX) return cudaErrorInvalidValue;
  const dim3 dw_grid(col_blocks, groups);
  cin_bwd_dw<H><<<dw_grid, dw_threads, dw_smem, stream>>>(
      x0, xk, y, dy, part, n, f0, fk, rows_per_group, tr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long slots = static_cast<long long>(tiles) * QT * H;
  cin_bwd_reduce<<<static_cast<unsigned>((slots + 31) / 32), 32 * RED_SLICES,
                   0, stream>>>(part, dw, db, groups, f0, fk, H);
  return cudaGetLastError();
}

}  // namespace

#define CIN_CASE(H)                                                          \
  case H:                                                                    \
    return static_cast<int>(launch<H>(x0, xk, w, y, dy, dx0, dxk, part, wt,  \
                                      dw, db, n, f0, fk, groups,             \
                                      rows_per_group, s));

// x0 [n, f0], xk [n, fk], w [f0*fk, h], y and dy [n, h] in; dx0 [n, f0],
// dxk [n, fk], dw [f0*fk, h], db [h] out. Scratch, 16-byte aligned: part,
// groups * h * (f0 * ceil(fk/4) + 1) * 4 floats (groups * rows_per_group
// >= n); wt, ceil(ceil(fk/4) / 2) * f0 * h * 8 floats. Launches on
// `stream`, does not synchronise.
extern "C" int cin_layer_bwd(const void* x0_p, const void* xk_p,
                             const void* w_p, const void* y_p,
                             const void* dy_p, void* dx0_p, void* dxk_p,
                             void* part_p, void* wt_p, void* dw_p, void* db_p,
                             int n, int f0, int fk, int h, int groups,
                             int rows_per_group, void* stream) {
  const auto* x0 = static_cast<const float*>(x0_p);
  const auto* xk = static_cast<const float*>(xk_p);
  const auto* w = static_cast<const float*>(w_p);
  const auto* y = static_cast<const float*>(y_p);
  const auto* dy = static_cast<const float*>(dy_p);
  auto* dx0 = static_cast<float*>(dx0_p);
  auto* dxk = static_cast<float*>(dxk_p);
  auto* part = static_cast<float*>(part_p);
  auto* wt = static_cast<float*>(wt_p);
  auto* dw = static_cast<float*>(dw_p);
  auto* db = static_cast<float*>(db_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f0 <= 0 || fk <= 0 || groups <= 0 || groups > 65535 ||
      rows_per_group <= 0 ||
      static_cast<long long>(groups) * rows_per_group < n)
    return static_cast<int>(cudaErrorInvalidValue);
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
