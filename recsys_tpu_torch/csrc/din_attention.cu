// DIN's target-attention unit for Hopper (sm_90a): the elementwise work
// round the unit's three products, forward and backward, as
// recsys_tpu_torch/ops/din_attention.py drives it. For a unit with history
// rows R = B·P of width K and hidden widths h_1..h_n:
//
//     X   = [h, q, h⊙q, h−q]                  [R, 4K]     din_build
//     Z_l = A_{l−1} · W_l                      cuBLAS (torch.matmul)
//     A_l = dropout(relu(Z_l + b_l))           in place    din_epilogue
//     wgt = A_n · w_out + b_out;  prod = hist·wgt·[id > 0]
//                                              [B, P, K]   din_pool
//     out = Σ_p prod                           torch.sum
//
// and the backward: din_head_backward (the pooling's and the output
// layer's gradients and the last hidden layer's dZ), din_epilogue_backward
// (dZ of each earlier hidden layer), cuBLAS for every dA and dW,
// din_fold (the gradients of hist and query from dX) and
// din_column_sums (the biases' and w_out's gradients from per-block
// partial sums).
//
// It replaces no TPU kernel: the JAX package's unit is elementwise code
// and dots that XLA fuses. The port ran it as plain PyTorch with autograd's
// backward, about 25 eager passes a unit over [131,072, 40–128] float32
// tensors at the benchmark's shape (B = 1,024, P = 128, K = 32, 80-40):
// cat's temporaries, each layer's bias add, ReLU, dropout's compare,
// scale, zeros and select, and in the backward their mirrors and column
// reductions, which moved about 3.4 GB a unit-step.
//
// What bounds it on the H100: bytes. Every kernel here does a few float32
// operations per element it reads or writes; the units' flops are the
// products', which stay cuBLAS's. So each kernel reads each of its inputs
// once and writes each output once, and keeps enough loads in flight:
//   - the forward's kernels are flat grid-stride loops over float4s where
//     the rows' widths are multiples of 4 and the pointers 16-B aligned
//     (scalar loops otherwise); din_epilogue writes A over Z;
//   - nothing is saved for the backward but X and the activations: the
//     gradient through ReLU and dropout is nonzero exactly where A > 0
//     (a kept, positive value scaled by 1/keep > 1 stays positive), so no
//     mask is stored;
//   - the backward's column kernels give each block ROWS rows; a thread
//     owns one float4 of columns and a residue of the tile's rows, sums its
//     columns in registers, the block's threads add their sums in a fixed
//     order in shared memory and write one partial row; din_column_sums
//     adds the partial rows in a fixed order. No atomics anywhere: the
//     result does not depend on the schedule, and a graphed step is
//     bitwise an eager one;
//   - din_fold gives each block one example b: it writes d_hist for the
//     example's P rows and sums d_query over them in a fixed order.
// Why the products stay cuBLAS: the forward has to give, bitwise, the
// values the plain version gives, since a float32 product of another
// order moves the units' ReLU pre-activations across 0 on some rows, and
// the gradients with them; the same cuBLAS call on the same operands
// gives the same values.
//
// The forward's kernels compute each element with the plain version's
// IEEE float32 operations in its order (__f*_rn, which nvcc does not
// contract): z + b, then relu (NaN passes), then, with dropout, the kept
// value times the float32 reciprocal of keep — PyTorch's CUDA division by
// a Python scalar — and rand < keep compared in float32; wgt = m + b_out;
// prod = (hist · wgt) · mask.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libdin_attention.so
//             din_attention.cu
// Each C entry point returns the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;     // threads per block, every kernel
constexpr int ROWS = 128;        // rows per block of the column kernels
constexpr int MAX_SEGS = 16;     // partial arrays per din_column_sums launch
constexpr unsigned MAX_GRID = 1u << 20;

template <int V>
struct Vec {
  float e[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> v;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v.e[0] = t.x;
    v.e[1] = t.y;
    v.e[2] = t.z;
    v.e[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v.e[i] = p[i];
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.e[0], v.e[1], v.e[2], v.e[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v.e[i];
  }
}

__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);      // torch.relu: NaN passes
}

__device__ __forceinline__ bool real(const long long* ids, size_t r) {
  return ids[r] > 0;
}

unsigned grid_for(unsigned long long n) {
  const unsigned long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < MAX_GRID ? blocks : MAX_GRID);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// ---------------------------------------------------------------- forward

// X[r] = [h_r, q_b, h_r·q_b, h_r − q_b]; n = R·K/V vectors of hist.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_build_kernel(const float* __restrict__ hist,
                 const float* __restrict__ query, float* __restrict__ x,
                 unsigned n, unsigned kv, unsigned pkv, int K) {
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned r = i / kv;
    const unsigned c = i - r * kv;
    const unsigned b = i / pkv;
    const Vec<V> h = load<V>(hist + static_cast<size_t>(i) * V);
    const Vec<V> q = load<V>(query + static_cast<size_t>(b) * K + c * V);
    Vec<V> hq, hd;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      hq.e[e] = __fmul_rn(h.e[e], q.e[e]);
      hd.e[e] = __fsub_rn(h.e[e], q.e[e]);
    }
    float* xr = x + static_cast<size_t>(r) * 4 * K + c * V;
    store<V>(xr, h);
    store<V>(xr + K, q);
    store<V>(xr + 2 * K, hq);
    store<V>(xr + 3 * K, hd);
  }
}

// A = dropout(relu(Z + b)) over [R, h], in place; n = R·h/V vectors.
template <int V, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_epilogue_kernel(float* __restrict__ z, const float* __restrict__ bias,
                    const float* __restrict__ rnd, unsigned n, unsigned hv,
                    float keep, float inv_keep) {
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned c = i % hv;
    const size_t off = static_cast<size_t>(i) * V;
    Vec<V> a = load<V>(z + off);
    const Vec<V> b = load<V>(bias + c * V);
    Vec<V> u;
    if constexpr (DROP) u = load<V>(rnd + off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float t = relu(__fadd_rn(a.e[e], b.e[e]));
      if constexpr (DROP) {
        a.e[e] = u.e[e] < keep ? __fmul_rn(t, inv_keep) : 0.0f;
      } else {
        a.e[e] = t;
      }
    }
    store<V>(z + off, a);
  }
}

// wgt_r = m_r + b_out; prod[r] = (hist_r · wgt_r) · [id_r > 0];
// n = R·K/V vectors of hist.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_pool_kernel(const float* __restrict__ hist,
                const long long* __restrict__ ids,
                const float* __restrict__ m, const float* __restrict__ b_out,
                float* __restrict__ prod, float* __restrict__ wgt,
                unsigned n, unsigned kv) {
  const float bo = *b_out;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned r = i / kv;
    const float w = __fadd_rn(m[r], bo);
    const float mask = real(ids, r) ? 1.0f : 0.0f;
    const size_t off = static_cast<size_t>(i) * V;
    const Vec<V> h = load<V>(hist + off);
    Vec<V> p;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p.e[e] = __fmul_rn(__fmul_rn(h.e[e], w), mask);
    }
    store<V>(prod + off, p);
    if (i == r * kv) wgt[r] = w;
  }
}

// --------------------------------------------------------------- backward
//
// Sums over rows are taken in double from each thread's first addend to
// the partial rows and their total, so that they stay within float32's
// rounding of the exact sum whatever the batch: autograd's column
// reductions, against which the backward is held, come that close.

// The column pass shared by the head and the epilogue backward over one
// tile of `nrows` rows from `row0`, width h (hv = h/V column vectors):
// dz = gate(a)·scale(d) with d = da_of(i, c, off) (no gate without GATE);
// per column, Σ dz into part_b and, with WSUM, Σ a·s_dw[i] into part_w,
// one partial row per block.
template <int V, bool GATE, bool DROP, bool WSUM, typename DaFn>
__device__ __forceinline__ void column_pass(
    const float* a, float* dz, double* __restrict__ part_b,
    double* __restrict__ part_w, const float* s_dw, double* s_acc,
    int row0, int nrows, int h, float inv_keep, DaFn da_of) {
  const int hv = h / V;
  auto one_row = [&](int i, int c, double* sb, double* sw) {
    const size_t off = static_cast<size_t>(row0 + i) * h + c * V;
    const Vec<V> av = load<V>(a + off);
    Vec<V> d = da_of(i, c, off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (GATE) {
        const float t = DROP ? __fmul_rn(d.e[e], inv_keep) : d.e[e];
        d.e[e] = av.e[e] > 0.0f ? t : 0.0f;
      }
      sb[e] += d.e[e];
      if constexpr (WSUM) sw[e] += static_cast<double>(av.e[e]) * s_dw[i];
    }
    store<V>(dz + off, d);
  };
  if (hv <= THREADS) {
    const int G = THREADS / hv;
    const int g = threadIdx.x / hv;
    const int c = threadIdx.x - g * hv;
    double sb[V] = {}, sw[V] = {};
    if (g < G) {
      for (int i = g; i < nrows; i += G) one_row(i, c, sb, sw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s_acc[g * h + c * V + e] = sb[e];
        if constexpr (WSUM) s_acc[THREADS * V + g * h + c * V + e] = sw[e];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < h; j += THREADS) {
      double tb = 0.0, tw = 0.0;
      for (int k = 0; k < G; ++k) {
        tb += s_acc[k * h + j];
        if constexpr (WSUM) tw += s_acc[THREADS * V + k * h + j];
      }
      const size_t at = static_cast<size_t>(blockIdx.x) * h + j;
      if (part_b != nullptr) part_b[at] = tb;
      if constexpr (WSUM) part_w[at] = tw;
    }
    return;
  }
  for (int c = threadIdx.x; c < hv; c += THREADS) {
    double sb[V] = {}, sw[V] = {};
    for (int i = 0; i < nrows; ++i) one_row(i, c, sb, sw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const size_t at = static_cast<size_t>(blockIdx.x) * h + c * V + e;
      if (part_b != nullptr) part_b[at] = sb[e];
      if constexpr (WSUM) part_w[at] = sw[e];
    }
  }
}

// From the unit's output gradient: d_wgt_r = [id_r > 0]·Σ_k dout_bk·hist_rk
// (L lanes a row, each summing every L-th vector of K, then a shuffle
// tree); dz = gate(a)·scale(d_wgt_r·w_out) over [R, h] (without GATE, the
// gradient of X itself, a being X); partial rows of Σ dz (GATE only),
// Σ a·d_wgt (w_out's gradient) and Σ d_wgt (b_out's).
template <int V, int KV, bool GATE, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_head_backward_kernel(const float* __restrict__ dout,
                         const float* __restrict__ hist,
                         const long long* __restrict__ ids,
                         const float* __restrict__ a,
                         const float* __restrict__ w_out,
                         float* __restrict__ dz, double* __restrict__ part_b,
                         double* __restrict__ part_w,
                         double* __restrict__ part_bo, int rows, int P, int K,
                         int h, float inv_keep) {
  __shared__ float s_dw[ROWS];
  __shared__ double s_acc[2 * THREADS * V];
  const int row0 = blockIdx.x * ROWS;
  const int nrows = rows - row0 < ROWS ? rows - row0 : ROWS;
  const int kv = K / KV;               // vectors of KV floats a row
  int lanes = 1;                       // L: a power of two, at most 32
  while (lanes < kv && lanes < 32) lanes <<= 1;
  const int sub = threadIdx.x & (lanes - 1);
  // every thread takes each pass, so that the shuffles see whole warps
  for (int base = 0; base < nrows; base += THREADS / lanes) {
    const int i = base + threadIdx.x / lanes;
    const int r = row0 + i;
    float s = 0.0f;
    if (i < nrows) {
      const float* dr = dout + static_cast<size_t>(r / P) * K;
      const float* hr = hist + static_cast<size_t>(r) * K;
      for (int q = sub; q < kv; q += lanes) {
        const Vec<KV> x = load<KV>(hr + q * KV), y = load<KV>(dr + q * KV);
#pragma unroll
        for (int e = 0; e < KV; ++e) s = fmaf(y.e[e], x.e[e], s);
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (i < nrows && sub == 0) s_dw[i] = real(ids, r) ? s : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    double s = 0.0;
    for (int i = lane; i < nrows; i += 32) s += s_dw[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part_bo[blockIdx.x] = s;
  }
  column_pass<V, GATE, DROP, true>(
      a, dz, GATE ? part_b : nullptr, part_w, s_dw, s_acc, row0, nrows, h,
      inv_keep, [&](int i, int c, size_t) {
        const Vec<V> wo = load<V>(w_out + c * V);
        Vec<V> d;
#pragma unroll
        for (int e = 0; e < V; ++e) d.e[e] = __fmul_rn(s_dw[i], wo.e[e]);
        return d;
      });
}

// dz = gate(a)·scale(da) over [R, h], written over da; partial rows of
// Σ dz (the layer's bias gradient).
template <int V, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_epilogue_backward_kernel(float* da, const float* __restrict__ a,
                             double* __restrict__ part_b, int rows, int h,
                             float inv_keep) {
  __shared__ double s_acc[THREADS * V];
  const int row0 = blockIdx.x * ROWS;
  const int nrows = rows - row0 < ROWS ? rows - row0 : ROWS;
  column_pass<V, true, DROP, false>(
      a, da, part_b, nullptr, nullptr, s_acc, row0, nrows, h, inv_keep,
      [&](int, int, size_t off) { return load<V>(da + off); });
}

// One block an example b: d_hist[r] = dX_h + dX_p·q + dX_d + [id > 0]·
// dout·wgt_r for its P rows, d_query[b] = Σ_p (dX_q + dX_p·h − dX_d) in a
// fixed order. A thread owns a vector of V columns k and every G-th row.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_fold_kernel(const float* __restrict__ dx, const float* __restrict__ dout,
                const float* __restrict__ hist,
                const float* __restrict__ query,
                const long long* __restrict__ ids,
                const float* __restrict__ wgt, float* __restrict__ dhist,
                float* __restrict__ dquery, int P, int K) {
  __shared__ double s_q[THREADS * V];
  const size_t b = blockIdx.x;
  const int kv = K / V;
  auto slot = [&](int c, int p0, int step, double* acc) {
    const Vec<V> q = load<V>(query + b * K + c * V);
    const Vec<V> go = load<V>(dout + b * K + c * V);
    for (int p = p0; p < P; p += step) {
      const size_t r = b * P + p;
      const float* d = dx + r * 4 * K + c * V;
      const Vec<V> h = load<V>(hist + r * K + c * V);
      const Vec<V> dxh = load<V>(d), dxq = load<V>(d + K);
      const Vec<V> dxp = load<V>(d + 2 * K), dxd = load<V>(d + 3 * K);
      const bool m = real(ids, r);
      const float w = wgt[r];
      Vec<V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float pool = m ? go.e[e] * w : 0.0f;
        out.e[e] = dxh.e[e] + dxp.e[e] * q.e[e] + dxd.e[e] + pool;
        acc[e] += dxq.e[e] + dxp.e[e] * h.e[e] - dxd.e[e];
      }
      store<V>(dhist + r * K + c * V, out);
    }
  };
  if (kv <= THREADS) {
    const int G = THREADS / kv;
    const int g = threadIdx.x / kv;
    const int c = threadIdx.x - g * kv;
    double acc[V] = {};
    if (g < G) slot(c, g, G, acc);
#pragma unroll
    for (int e = 0; e < V; ++e) s_q[threadIdx.x * V + e] = acc[e];
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += THREADS) {
      double s = 0.0;
      for (int j = 0; j < G; ++j) s += s_q[j * K + k];
      dquery[b * K + k] = static_cast<float>(s);
    }
    return;
  }
  for (int c = threadIdx.x; c < kv; c += THREADS) {
    double acc[V] = {};
    slot(c, 0, 1, acc);
#pragma unroll
    for (int e = 0; e < V; ++e) dquery[b * K + c * V + e] = static_cast<float>(acc[e]);
  }
}

struct Segments {
  const double* part[MAX_SEGS];    // [nblk, cols] partial rows
  float* out[MAX_SEGS];            // [cols]
  int nblk[MAX_SEGS];
  int cols[MAX_SEGS];
  int first_block[MAX_SEGS];
  int count;
};

// out[j] = Σ_blk part[blk, j], 32 columns a block: each warp sums every
// 8th partial row in order, then warp 0 adds the 8 sums in order.
__global__ void __launch_bounds__(THREADS)
din_column_sums_kernel(const __grid_constant__ Segments S) {
  __shared__ double s_sum[THREADS / 32][32];
  int s = 0;
  while (s + 1 < S.count && S.first_block[s + 1] <= static_cast<int>(blockIdx.x)) ++s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = S.cols[s];
  const int j = (static_cast<int>(blockIdx.x) - S.first_block[s]) * 32 + lane;
  double t = 0.0;
  if (j < cols) {
    const double* p = S.part[s];
#pragma unroll 4
    for (int blk = warp; blk < S.nblk[s]; blk += THREADS / 32) {
      t += p[static_cast<size_t>(blk) * cols + j];
    }
  }
  s_sum[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && j < cols) {
    double u = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) u += s_sum[w][lane];
    S.out[s][j] = static_cast<float>(u);
  }
}

// ------------------------------------------- fused backward, two layers
//
// One kernel for the whole backward of a unit with two hidden layers of
// widths H1, H2 and embeddings of width K, the shapes DIN trains (K = 32,
// 80-40). A block owns a contiguous range of examples b (static: block g
// takes [g·B/G, (g+1)·B/G)) and their histories in tiles of TILE
// consecutive positions. It first reads every id of its examples: a tile
// whose ids are all 0 (padding) is skipped and its rows of d_hist written
// as zeros, since on such rows d_wgt = 0, so dZ2, dA1, dZ1 and dX are
// exactly 0 and so is each of their shares of the weights' gradients. The
// other tiles go in a list, in order, and each is computed whole, its
// padded rows adding exact zeros, so nothing rests on the padding being at
// the end. On a computed tile, in shared memory only:
//
//     d_wgt_r = [id_r > 0]·Σ_k dout_k·h_rk               TILE rows
//     dZ2 = [A2 > 0]·(d_wgt ⊗ w_out)/keep                 [TILE, H2]
//     dA1 = dZ2·W2ᵀ,  dZ1 = [A1 > 0]·dA1/keep             [TILE, H1]
//     dW2 += A1ᵀ·dZ2                                      [H1, H2]
//     G   += hᵀ·dZ1,  s += Σ_r dZ1                        [K, H1], [H1]
//     d_hist = dZ1·W_effᵀ + [id > 0]·dout·wgt             [TILE, K]
//
// X = [h, q, h⊙q, h−q] is never read: its four column groups are h and q
// of the example, so X's gradient folds into d_hist through the example's
// W_eff[k, i] = W1[k, i] + q_k·W1[2K+k, i] + W1[3K+k, i], and the example's
// sums give the rest: d_query_k = Σ_i s_i·(W1[K+k, i] − W1[3K+k, i])
// + W1[2K+k, i]·G_ki, and dW1's four row groups are Σ_b G, Σ_b q⊗s,
// Σ_b q·G and Σ_b G − q⊗s. That is 2·(K + H2)·H1 multiply-adds a row for
// the products (dA1, dW2, G, d_hist) where dX and dW1 as products of X take
// 2·(4K + H2)·H1; d_query's sum over the example stays in one block, in a
// fixed order.
//
// What bounds it: float32 FFMA (no TF32: the configuration's float32). A
// computed tile does about 370k multiply-adds on 19 KB of inputs, so the
// products are register-blocked from shared memory: W2ᵀ and the example's
// W_eff stay resident, warps 0-3 run dA1 (4 rows × H1/16 columns a thread,
// a float4 of dZ2ᵀ against H1/16 conflict-free loads of W2ᵀ a step) then
// d_hist, while warps 4-7 run dW2 (H1/16 × H2/8 a thread) then G, whose
// sums stay in their registers across the block's tiles. The next listed
// tile's A1, A2, hist, ids and wgt are copied in (cp.async) while the
// current one's d_hist and G run, and two blocks share an SM
// (__launch_bounds__(256, 2), about 110 KB of shared memory each), so the
// loads' latency hides behind products.
//
// Sums: each block adds its rows in a fixed order (float32 in the
// products; double for d_wgt's dot product, whose float32 rounding b_out's
// sum over 10^5 rows would show, and for the biases' and w_out's columns)
// and writes one double partial row of every weight and bias gradient;
// din_column_sums adds the partial rows in order. No atomics on any
// result: the one atomicAdd a block makes is to the integer tile counter
// (tiles, computed) when one is given. Two runs give the same bits, and so
// does a graph.
//
// What is left above the bound: a computed tile costs an SM
// about 4.5 µs, some 30% of the FFMA rate, and blocks own 3 or 4 examples
// of up to 4 computed tiles each, so the SM with the most tiles sets the
// time.

constexpr int TILE = 32;         // history positions a tile
constexpr int LIST = 256;        // tiles a block lists at a time
static_assert(THREADS == 8 * TILE, "eight warps of a lane a row");

constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Offsets, in floats, of the fused kernel's shared arrays.
template <int K, int H1, int H2>
struct FusedLayout {
  static constexpr int WE_LD = K + 1;        // W_effᵀ [H1][K+1]
  static constexpr int Z2_LD = H2 + 1;       // A2, then dZ2 [TILE][H2+1]
  static constexpr int Z1T_LD = TILE + 4;    // dZ1ᵀ [H1][TILE+4]
  static constexpr int W2T = 0;                           // [H2][H1]
  static constexpr int WE = up4(W2T + H2 * H1);
  static constexpr int ACC = up4(WE + H1 * WE_LD);        // [3][K][H1]
  static constexpr int H = up4(ACC + 3 * K * H1);         // [2][TILE][K]
  static constexpr int A1 = up4(H + 2 * TILE * K);        // [TILE][H1]
  static constexpr int Z2 = up4(A1 + TILE * H1);
  static constexpr int Z2T = up4(Z2 + TILE * Z2_LD);      // [H2][TILE]
  static constexpr int Z1 = up4(Z2T + H2 * TILE);         // [TILE][H1]
  static constexpr int Z1T = up4(Z1 + TILE * H1);
  static constexpr int WR = up4(Z1T + H1 * Z1T_LD);       // wgt [2][TILE]
  static constexpr int Q = WR + 2 * TILE;                 // query [K]
  static constexpr int GO = Q + K;                        // dout [K]
  static constexpr int S = GO + K;                        // s [H1]
  static constexpr int PS = S + H1;                       // [8][H1]
  static constexpr int DQ = PS + 8 * H1;                  // [16][K]
  static constexpr int LST = DQ + 16 * K;                 // int [LIST]
  static constexpr int CNT = LST + LIST;                  // int: listed
  static constexpr int WIDE = up4(CNT + 1);               // then 8-byte:
  static constexpr int DB1 = 0;                           //   d_b1 [H1]
  static constexpr int DB2 = H1;                          //   d_b2 [H2]
  static constexpr int DWO = DB2 + H2;                    //   d_w_out [H2]
  static constexpr int DBO = DWO + H2;                    //   d_b_out [1]
  static constexpr int ID = DBO + 1;                      //   ids [2][TILE]
  static constexpr size_t BYTES = 4 * WIDE + 8 * (ID + 2 * TILE);
};

// cp.async of N bytes into shared memory, or N zeros where !full.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(N), "r"(full ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int K, int H1, int H2>
__global__ void __launch_bounds__(THREADS, 2)
din_fused_backward_kernel(
    const float* __restrict__ dout, const float* __restrict__ hist,
    const float* __restrict__ query, const long long* __restrict__ ids,
    const float* __restrict__ wgt, const float* __restrict__ a1,
    const float* __restrict__ a2, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ w_out,
    float* __restrict__ dhist, float* __restrict__ dquery,
    double* __restrict__ part_w1, double* __restrict__ part_b1,
    double* __restrict__ part_w2, double* __restrict__ part_b2,
    double* __restrict__ part_wo, double* __restrict__ part_bo,
    unsigned long long* __restrict__ tiles, int B, int P, float inv_keep) {
  using L = FusedLayout<K, H1, H2>;
  static_assert(K == 16 || K == 32, "the rotated d_wgt sum and G's float4");
  static_assert(H1 % 16 == 0 && H2 % 8 == 0, "the thread maps below");
  constexpr int HALF = THREADS / 2;   // warps 0-3 | warps 4-7
  constexpr int IE = H1 / 16;         // columns i = x + 16e of a thread
  constexpr int JF = H2 / 8;          // dW2's columns j = g + 8f
  constexpr int KE = K / 16;          // d_hist's k = x + 16c
  constexpr int KPT = K / 8;          // G's k = g·KPT + c
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sW2T = sm + L::W2T;
  float* sWe = sm + L::WE;
  float* sAcc = sm + L::ACC;
  float* sA1 = sm + L::A1;
  float* sZ2 = sm + L::Z2;
  float* sZ2T = sm + L::Z2T;
  float* sZ1 = sm + L::Z1;
  float* sZ1T = sm + L::Z1T;
  float* sQ = sm + L::Q;
  float* sGo = sm + L::GO;
  float* sS = sm + L::S;
  float* sPS = sm + L::PS;
  float* sDQ = sm + L::DQ;
  int* sList = reinterpret_cast<int*>(sm + L::LST);
  double* sD = reinterpret_cast<double*>(sm + L::WIDE);
  long long* sId0 = reinterpret_cast<long long*>(sm + L::WIDE) + L::ID;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool first_half = tid < HALF;
  const int u = tid & (HALF - 1);
  const int g = u >> 4, x = u & 15;   // g in 0..7, x in 0..15
  const int b_lo = static_cast<int>(1LL * blockIdx.x * B / gridDim.x);
  const int b_hi = static_cast<int>(1LL * (blockIdx.x + 1) * B / gridDim.x);
  const int ntiles = (P + TILE - 1) / TILE;
  const int chunk = LIST / ntiles;    // examples listed at a time (≥ 1)

  for (int e = tid; e < H1 * H2; e += THREADS) {
    const int i = e / H2, j = e - i * H2;
    sW2T[j * H1 + i] = w2[e];
  }
  for (int e = tid; e < 3 * K * H1; e += THREADS) sAcc[e] = 0.0f;
  for (int e = tid; e < L::ID; e += THREADS) sD[e] = 0.0;

  float dw2[IE][JF] = {};             // warps 4-7: dW2[x + 16e][g + 8f]
  float gk[KPT][IE];                  // warps 4-7: G[g·KPT + c][x + 16e]
  unsigned long long n_tiles = 0, n_done = 0;

  // the listed tile j of the examples from c0 into buffer nb
  auto fetch = [&](int c0, int j, int nb) {
    const int b = c0 + j / ntiles;
    const int p0 = (j - (j / ntiles) * ntiles) * TILE;
    const int nr = P - p0 < TILE ? P - p0 : TILE;
    const size_t row0 = static_cast<size_t>(b) * P + p0;
    float* sH = sm + L::H + nb * TILE * K;
    for (int e = tid; e < TILE * K / 4; e += THREADS) {
      const bool in = e / (K / 4) < nr;
      cp_async<16>(sH + 4 * e, in ? hist + row0 * K + 4 * e : hist, in);
    }
    for (int e = tid; e < TILE * H1 / 4; e += THREADS) {
      const bool in = e / (H1 / 4) < nr;
      cp_async<16>(sA1 + 4 * e, in ? a1 + row0 * H1 + 4 * e : a1, in);
    }
    for (int e = tid; e < TILE * H2; e += THREADS) {
      const int r = e / H2;
      const bool in = r < nr;
      cp_async<4>(sZ2 + r * L::Z2_LD + e - r * H2, in ? a2 + row0 * H2 + e : a2,
                  in);
    }
    if (tid < TILE) {
      const bool in = tid < nr;
      cp_async<8>(sId0 + nb * TILE + tid, in ? ids + row0 + tid : ids, in);
      cp_async<4>(sm + L::WR + nb * TILE + tid, in ? wgt + row0 + tid : wgt, in);
    }
    cp_async_commit();
  };


  // an example's query, output gradient and W_eff, its G and s zeroed
  auto example_begin = [&](int b) {
    if (tid < K) {
      sQ[tid] = query[static_cast<size_t>(b) * K + tid];
      sGo[tid] = dout[static_cast<size_t>(b) * K + tid];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < (K * H1 + THREADS - 1) / THREADS; ++n) {
      const int e = tid + n * THREADS;
      if (e < K * H1) {
        const int k = e / H1, i = e - k * H1;
        sWe[i * L::WE_LD + k] =
            fmaf(sQ[k], w1[(2 * K + k) * H1 + i], w1[e]) + w1[(3 * K + k) * H1 + i];
      }
    }
    for (int i = tid; i < H1; i += THREADS) sS[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < IE; ++e) {
#pragma unroll
      for (int c = 0; c < KPT; ++c) gk[c][e] = 0.0f;
    }
  };

  // an example's end: dW1's sums, d_b1 and d_query from its G and s
  auto example_end = [&](int b) {
    __syncthreads();
    for (int i = tid; i < H1; i += THREADS) sD[L::DB1 + i] += sS[i];
    if (!first_half) {
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int k = KPT * g + c;
        const float q = sQ[k];
        float dq = 0.0f;
#pragma unroll
        for (int e = 0; e < IE; ++e) {
          const int i = x + 16 * e;
          const float gv = gk[c][e], si = sS[i];
          sAcc[k * H1 + i] += gv;
          sAcc[(K + k) * H1 + i] += q * gv;
          sAcc[(2 * K + k) * H1 + i] += q * si;
          dq = fmaf(si, w1[(K + k) * H1 + i] - w1[(3 * K + k) * H1 + i], dq);
          dq = fmaf(w1[(2 * K + k) * H1 + i], gv, dq);
        }
        sDQ[x * K + k] = dq;
      }
    }
    __syncthreads();
    if (tid < K) {
      float s = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) s += sDQ[jj * K + tid];
      dquery[static_cast<size_t>(b) * K + tid] = s;
    }
  };

  for (int c0 = b_lo; c0 < b_hi; c0 += chunk) {
    const int c1 = b_hi - c0 < chunk ? b_hi : c0 + chunk;
    const int n = (c1 - c0) * ntiles;
    // list the tiles that hold an id; zeros for the others' rows of d_hist
    // and for d_query, which each example's end writes over
    for (int e = tid; e < (c1 - c0) * K; e += THREADS) {
      dquery[static_cast<size_t>(c0) * K + e] = 0.0f;
    }
    for (int j = warp; j < n; j += THREADS / 32) {
      const int b = c0 + j / ntiles;
      const int p0 = (j - (j / ntiles) * ntiles) * TILE;
      const int nr = P - p0 < TILE ? P - p0 : TILE;
      const size_t row0 = static_cast<size_t>(b) * P + p0;
      const unsigned any =
          __ballot_sync(0xffffffffu, lane < nr && ids[row0 + lane] > 0);
      if (!any) {
        for (int e = lane; e < nr * K; e += 32) dhist[row0 * K + e] = 0.0f;
      }
      if (lane == 0) sList[j] = any != 0;
    }
    __syncthreads();
    if (warp == 0) {  // compacted in place, in order
      int listed = 0;
      for (int base = 0; base < n; base += 32) {
        const bool f = base + lane < n && sList[base + lane] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) sList[listed + __popc(bal & ((1u << lane) - 1u))] = base + lane;
        listed += __popc(bal);
      }
      if (lane == 0) reinterpret_cast<int*>(sm + L::CNT)[0] = listed;
    }
    __syncthreads();
    const int listed = reinterpret_cast<int*>(sm + L::CNT)[0];
    n_tiles += n;
    n_done += listed;

    int cur = -1;                       // the example being summed
    if (listed > 0) fetch(c0, sList[0], 0);
    for (int m = 0; m < listed; ++m) {
      const int nb = m & 1;
      const int j = sList[m];
      const int b = c0 + j / ntiles;
      const int p0 = (j - (j / ntiles) * ntiles) * TILE;
      const int nr = P - p0 < TILE ? P - p0 : TILE;
      const size_t row0 = static_cast<size_t>(b) * P + p0;
      const float* sH = sm + L::H + nb * TILE * K;
      const long long* sId = sId0 + nb * TILE;
      const float* sWr = sm + L::WR + nb * TILE;
      if (b != cur) {
        if (cur >= 0) example_end(cur);
        example_begin(b);
        cur = b;
      }
      cp_async_wait();
      __syncthreads();

      {  // d_wgt of row `lane` (each warp), then dZ2 over A2 (j = warp + 8m)
        double dd = 0.0;   // in double, so that b_out's sum keeps its digits
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const int k = (lane + kk) & (K - 1);   // conflict-free rotation
          dd = fma(static_cast<double>(sGo[k]),
                   static_cast<double>(sH[lane * K + k]), dd);
        }
        dd = sId[lane] > 0 ? dd : 0.0;
        const float d = static_cast<float>(dd);
        if (warp == 0) {       // b_out: the tile's sum, over lanes in a tree
          double t = dd;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
          if (lane == 0) sD[L::DBO] += t;
        }
#pragma unroll
        for (int mm = 0; mm < JF; ++mm) {
          const int jj = warp + 8 * mm;
          float* p = sZ2 + lane * L::Z2_LD + jj;
          const float a = *p;
          const float z =
              a > 0.0f ? __fmul_rn(__fmul_rn(d, w_out[jj]), inv_keep) : 0.0f;
          *p = z;
          sZ2T[jj * TILE + lane] = z;
          double tb = z, tw = static_cast<double>(a) * dd;  // the columns' sums
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            tb += __shfl_xor_sync(0xffffffffu, tb, o);
            tw += __shfl_xor_sync(0xffffffffu, tw, o);
          }
          if (lane == 0) {
            sD[L::DB2 + jj] += tb;
            sD[L::DWO + jj] += tw;
          }
        }
      }
      __syncthreads();

      if (first_half) {  // dA1 = dZ2·W2ᵀ → dZ1, rows 4g..4g+3
        float acc[4][IE] = {};
#pragma unroll 4
        for (int jj = 0; jj < H2; ++jj) {
          const float4 a = *reinterpret_cast<const float4*>(sZ2T + jj * TILE + 4 * g);
#pragma unroll
          for (int e = 0; e < IE; ++e) {
            const float w = sW2T[jj * H1 + x + 16 * e];
            acc[0][e] = fmaf(a.x, w, acc[0][e]);
            acc[1][e] = fmaf(a.y, w, acc[1][e]);
            acc[2][e] = fmaf(a.z, w, acc[2][e]);
            acc[3][e] = fmaf(a.w, w, acc[3][e]);
          }
        }
#pragma unroll
        for (int e = 0; e < IE; ++e) {
          const int i = x + 16 * e;
          float z[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 4 * g + r;
            z[r] = sA1[row * H1 + i] > 0.0f ? __fmul_rn(acc[r][e], inv_keep) : 0.0f;
            sZ1[row * H1 + i] = z[r];
          }
          *reinterpret_cast<float4*>(sZ1T + i * L::Z1T_LD + 4 * g) =
              make_float4(z[0], z[1], z[2], z[3]);
          sPS[g * H1 + i] = (z[0] + z[1]) + (z[2] + z[3]);   // s's share
        }
      } else {  // dW2 += A1ᵀ·dZ2
#pragma unroll 2
        for (int r = 0; r < TILE; ++r) {
          float av[IE], bv[JF];
#pragma unroll
          for (int e = 0; e < IE; ++e) av[e] = sA1[r * H1 + x + 16 * e];
#pragma unroll
          for (int f = 0; f < JF; ++f) bv[f] = sZ2[r * L::Z2_LD + g + 8 * f];
#pragma unroll
          for (int e = 0; e < IE; ++e) {
#pragma unroll
            for (int f = 0; f < JF; ++f) dw2[e][f] = fmaf(av[e], bv[f], dw2[e][f]);
          }
        }
      }
      __syncthreads();
      // A1 and A2 are spent: the next listed tile comes in behind d_hist, G
      if (m + 1 < listed) fetch(c0, sList[m + 1], nb ^ 1);

      if (first_half) {  // d_hist = dZ1·W_effᵀ + the pooling's share
        for (int i = tid; i < H1; i += HALF) {   // s += the tile's Σ_r dZ1
          float t = 0.0f;
#pragma unroll
          for (int gg = 0; gg < 8; ++gg) t += sPS[gg * H1 + i];
          sS[i] += t;
        }
        float acc[4][KE] = {};
#pragma unroll 4
        for (int i = 0; i < H1; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(sZ1T + i * L::Z1T_LD + 4 * g);
#pragma unroll
          for (int c = 0; c < KE; ++c) {
            const float w = sWe[i * L::WE_LD + x + 16 * c];
            acc[0][c] = fmaf(a.x, w, acc[0][c]);
            acc[1][c] = fmaf(a.y, w, acc[1][c]);
            acc[2][c] = fmaf(a.z, w, acc[2][c]);
            acc[3][c] = fmaf(a.w, w, acc[3][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * g + r;
          if (row < nr) {
            const float wm = sId[row] > 0 ? sWr[row] : 0.0f;
#pragma unroll
            for (int c = 0; c < KE; ++c) {
              const int k = x + 16 * c;
              dhist[(row0 + row) * K + k] = acc[r][c] + sGo[k] * wm;
            }
          }
        }
      } else {  // G += hᵀ·dZ1
#pragma unroll 2
        for (int r = 0; r < TILE; ++r) {
          float hv[KPT], bv[IE];
          if constexpr (KPT == 4) {
            const float4 h4 = *reinterpret_cast<const float4*>(sH + r * K + 4 * g);
            hv[0] = h4.x;
            hv[1] = h4.y;
            hv[2] = h4.z;
            hv[3] = h4.w;
          } else {
            const float2 h2 = *reinterpret_cast<const float2*>(sH + r * K + 2 * g);
            hv[0] = h2.x;
            hv[1] = h2.y;
          }
#pragma unroll
          for (int e = 0; e < IE; ++e) bv[e] = sZ1[r * H1 + x + 16 * e];
#pragma unroll
          for (int c = 0; c < KPT; ++c) {
#pragma unroll
            for (int e = 0; e < IE; ++e) gk[c][e] = fmaf(hv[c], bv[e], gk[c][e]);
          }
        }
      }
    }
    if (cur >= 0) example_end(cur);
  }

  // the block's partial rows
  __syncthreads();
  const size_t blk = blockIdx.x;
  for (int e = tid; e < K * H1; e += THREADS) {
    const float gs = sAcc[e], qg = sAcc[K * H1 + e], qs = sAcc[2 * K * H1 + e];
    double* row = part_w1 + blk * 4 * K * H1;
    row[e] = gs;
    row[K * H1 + e] = qs;
    row[2 * K * H1 + e] = qg;
    row[3 * K * H1 + e] = gs - qs;
  }
  for (int i = tid; i < H1; i += THREADS) part_b1[blk * H1 + i] = sD[L::DB1 + i];
  for (int j = tid; j < H2; j += THREADS) {
    part_b2[blk * H2 + j] = sD[L::DB2 + j];
    part_wo[blk * H2 + j] = sD[L::DWO + j];
  }
  if (!first_half) {
#pragma unroll
    for (int e = 0; e < IE; ++e) {
#pragma unroll
      for (int f = 0; f < JF; ++f) {
        part_w2[blk * H1 * H2 + (x + 16 * e) * H2 + g + 8 * f] = dw2[e][f];
      }
    }
  }
  if (tid == 0) {
    part_bo[blk] = sD[L::DBO];
    if (tiles != nullptr) {
      atomicAdd(tiles, n_tiles);
      atomicAdd(tiles + 1, n_done);
    }
  }
}

template <int K, int H1, int H2>
int launch_fused_backward(const float* dout, const float* hist,
                          const float* query, const long long* ids,
                          const float* wgt, const float* a1, const float* a2,
                          const float* w1, const float* w2, const float* w_out,
                          float* dhist, float* dquery, double* const* parts,
                          long long* tiles, int B, int P, int grid,
                          float inv_keep, cudaStream_t st) {
  auto kernel = din_fused_backward_kernel<K, H1, H2>;
  constexpr size_t bytes = FusedLayout<K, H1, H2>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, st>>>(
      dout, hist, query, ids, wgt, a1, a2, w1, w2, w_out, dhist, dquery,
      parts[0], parts[1], parts[2], parts[3], parts[4], parts[5],
      reinterpret_cast<unsigned long long*>(tiles), B, P, inv_keep);
  return launched();
}

}  // namespace

extern "C" {

// X [B·P, 4K] from hist [B, P, K] and query [B, K]. Does not synchronise.
int din_build(const float* hist, const float* query, float* x, int B, int P,
              int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * B * P * K;
  if (elems == 0) return 0;
  if (K % 4 == 0 && aligned16(hist) && aligned16(query) && aligned16(x)) {
    const unsigned n = static_cast<unsigned>(elems / 4);
    const unsigned kv = K / 4;
    din_build_kernel<4><<<grid_for(n), THREADS, 0, st>>>(
        hist, query, x, n, kv, kv * P, K);
  } else {
    const unsigned n = static_cast<unsigned>(elems);
    din_build_kernel<1><<<grid_for(n), THREADS, 0, st>>>(
        hist, query, x, n, K, 1u * K * P, K);
  }
  return launched();
}

// A = dropout(relu(Z + b)) over Z [rows, h], in place; rnd [rows, h] of
// uniforms (dropout keeps rnd < keep), or null for no dropout.
int din_epilogue(float* z, const float* bias, const float* rnd, int rows,
                 int h, float keep, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * rows * h;
  if (elems == 0) return 0;
  const bool vec = h % 4 == 0 && aligned16(z) && aligned16(bias) &&
                   (rnd == nullptr || aligned16(rnd));
  const unsigned n = static_cast<unsigned>(vec ? elems / 4 : elems);
  const unsigned hv = vec ? h / 4 : h;
  if (vec && rnd) {
    din_epilogue_kernel<4, true><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else if (vec) {
    din_epilogue_kernel<4, false><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else if (rnd) {
    din_epilogue_kernel<1, true><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else {
    din_epilogue_kernel<1, false><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  }
  return launched();
}

// wgt [B·P] = m + b_out and prod [B, P, K] = hist·wgt·[id > 0], from
// hist [B, P, K], ids [B, P] (int64), m [B·P] and b_out [1].
int din_pool(const float* hist, const long long* ids, const float* m,
             const float* b_out, float* prod, float* wgt, int B, int P, int K,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * B * P * K;
  if (elems == 0) return 0;
  const bool vec = K % 4 == 0 && aligned16(hist) && aligned16(prod);
  const unsigned n = static_cast<unsigned>(vec ? elems / 4 : elems);
  const unsigned kv = vec ? K / 4 : K;
  if (vec) {
    din_pool_kernel<4><<<grid_for(n), THREADS, 0, st>>>(hist, ids, m, b_out,
                                                        prod, wgt, n, kv);
  } else {
    din_pool_kernel<1><<<grid_for(n), THREADS, 0, st>>>(hist, ids, m, b_out,
                                                        prod, wgt, n, kv);
  }
  return launched();
}

// The head of the backward: dz [B·P, h] and the partial rows part_b
// [nblk, h] (gate only; null otherwise), part_w [nblk, h], part_bo [nblk]
// (double) from dout [B, K], hist, ids (int64), a [B·P, h] (the last hidden
// activation, or X without hidden layers, gate = 0) and w_out [h];
// nblk = ceil(B·P/ROWS).
int din_head_backward(const float* dout, const float* hist,
                      const long long* ids, const float* a,
                      const float* w_out, float* dz, double* part_b,
                      double* part_w, double* part_bo, int B, int P, int K,
                      int h, int gate, int drop, float inv_keep,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * P;
  if (rows == 0) return 0;
  const unsigned grid = (rows + ROWS - 1) / ROWS;
  const bool vec = h % 4 == 0 && aligned16(a) && aligned16(w_out) &&
                   aligned16(dz);
  const bool kvec = K % 4 == 0 && aligned16(hist) && aligned16(dout);
#define DIN_HEAD_K(V, KV, G, D)                                              \
  din_head_backward_kernel<V, KV, G, D><<<grid, THREADS, 0, st>>>(           \
      dout, hist, ids, a, w_out, dz, part_b, part_w, part_bo, rows, P, K, h, \
      inv_keep);
#define DIN_HEAD(V, G, D)                                                    \
  if (kvec) { DIN_HEAD_K(V, 4, G, D) } else { DIN_HEAD_K(V, 1, G, D) }
  if (vec) {
    if (gate && drop) { DIN_HEAD(4, true, true) }
    else if (gate) { DIN_HEAD(4, true, false) }
    else { DIN_HEAD(4, false, false) }
  } else {
    if (gate && drop) { DIN_HEAD(1, true, true) }
    else if (gate) { DIN_HEAD(1, true, false) }
    else { DIN_HEAD(1, false, false) }
  }
#undef DIN_HEAD
#undef DIN_HEAD_K
  return launched();
}

// dz = gate(a)·scale(da) over [rows, h], written over da, and the partial
// rows part_b [ceil(rows/ROWS), h] (double).
int din_epilogue_backward(float* da, const float* a, double* part_b,
                          int rows, int h, int drop, float inv_keep,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  const unsigned grid = (rows + ROWS - 1) / ROWS;
  const bool vec = h % 4 == 0 && aligned16(da) && aligned16(a);
  if (vec && drop) {
    din_epilogue_backward_kernel<4, true><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else if (vec) {
    din_epilogue_backward_kernel<4, false><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else if (drop) {
    din_epilogue_backward_kernel<1, true><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else {
    din_epilogue_backward_kernel<1, false><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  }
  return launched();
}

// d_hist [B, P, K] and d_query [B, K] from dx [B·P, 4K], dout [B, K],
// hist, query, ids and wgt [B·P].
int din_fold(const float* dx, const float* dout, const float* hist,
             const float* query, const long long* ids, const float* wgt,
             float* dhist, float* dquery, int B, int P, int K,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0) return 0;
  const bool vec = K % 4 == 0 && aligned16(dx) && aligned16(dout) &&
                   aligned16(hist) && aligned16(query) && aligned16(dhist);
  if (vec) {
    din_fold_kernel<4><<<B, THREADS, 0, st>>>(dx, dout, hist, query, ids, wgt,
                                             dhist, dquery, P, K);
  } else {
    din_fold_kernel<1><<<B, THREADS, 0, st>>>(dx, dout, hist, query, ids, wgt,
                                             dhist, dquery, P, K);
  }
  return launched();
}

// The whole backward of a unit with two hidden layers at (K, h1, h2) =
// (32, 80, 40) or (16, 80, 40): d_hist [B, P, K], d_query [B, K] and, in
// `grid` double partial rows each, dW1 [4K·h1], d_b1 [h1], dW2 [h1·h2],
// d_b2 [h2], d_w_out [h2] and d_b_out [1] (part_w1 .. part_bo), from dout
// [B, K], hist, query, ids (int64), wgt [B·P], the activations a1 [B·P, h1]
// and a2 [B·P, h2], W1 [4K, h1], W2 [h1, h2] and w_out [h2]; every float
// pointer 16-B aligned. tiles (int64 [2], or null) gains the tiles in all
// and the tiles computed. Another shape, or P above LIST·TILE, returns
// cudaErrorInvalidValue.
int din_fused_backward(const float* dout, const float* hist,
                       const float* query, const long long* ids,
                       const float* wgt, const float* a1, const float* a2,
                       const float* w1, const float* w2, const float* w_out,
                       float* dhist, float* dquery, double* part_w1,
                       double* part_b1, double* part_w2, double* part_b2,
                       double* part_wo, double* part_bo, long long* tiles,
                       int B, int P, int K, int h1, int h2, int grid,
                       float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || P == 0) return 0;
  if ((P + TILE - 1) / TILE > LIST) return static_cast<int>(cudaErrorInvalidValue);
  double* const parts[6] = {part_w1, part_b1, part_w2, part_b2, part_wo, part_bo};
  if (h1 == 80 && h2 == 40 && K == 32) {
    return launch_fused_backward<32, 80, 40>(
        dout, hist, query, ids, wgt, a1, a2, w1, w2, w_out, dhist, dquery,
        parts, tiles, B, P, grid, inv_keep, st);
  }
  if (h1 == 80 && h2 == 40 && K == 16) {
    return launch_fused_backward<16, 80, 40>(
        dout, hist, query, ids, wgt, a1, a2, w1, w2, w_out, dhist, dquery,
        parts, tiles, B, P, grid, inv_keep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out_i[j] = Σ_blk part_i[blk, j] for n arrays of double partial rows into
// float32 (device addresses as integers), MAX_SEGS a launch, in order.
int din_column_sums(int n, const long long* parts, const long long* outs,
                    const int* nblk, const int* cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Segments S{};
  int blocks = 0;
  for (int i = 0; i <= n; ++i) {
    if (i < n && cols[i] > 0) {
      const int k = S.count++;
      S.part[k] = reinterpret_cast<const double*>(parts[i]);
      S.out[k] = reinterpret_cast<float*>(outs[i]);
      S.nblk[k] = nblk[i];
      S.cols[k] = cols[i];
      S.first_block[k] = blocks;
      blocks += (cols[i] + 31) / 32;
    }
    if (S.count > 0 && (S.count == MAX_SEGS || i == n)) {
      din_column_sums_kernel<<<blocks, THREADS, 0, st>>>(S);
      const int err = launched();
      if (err != 0) return err;
      S = Segments{};
      blocks = 0;
    }
  }
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
