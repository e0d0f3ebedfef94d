// Train-mode BatchNorm for Hopper (sm_90a), fused with what follows it: the
// residual add and the ReLU of a bottleneck's tail, or a conv's ReLU.
//
//   forward   y  = act((x - mean) * w * rstd + b [+ res])      act: ReLU or none
//   backward  g  = dy * [y > 0] (a ReLU follows) or dy
//             dx = w * rstd * (g - sum(g) / n - xhat * sum(g * xhat) / n)
//             dw = sum(g * xhat), db = sum(g), dres = g
//
// x is the conv's output as a row-major [M, C] matrix (a channels-last
// activation; a row may be wider than C, as a channel slice of a wider tensor
// is), bf16 or f32.  The rows split into `groups` equal ranges, each with its
// own statistics (the fused labeled + unlabeled forward).  Statistics are the
// reference's: f32 sums of x and x^2, mean, E[x^2] - mean^2 as the variance,
// and the running stats moved with momentum, group 0 first, each time with
// the unbiased n / (n - 1) variance.
//
// Which TPU kernel these replace.  None: css_tpu's GroupedBatchNorm is plain
// JAX, and XLA fuses the normalisation and its neighbours into the
// convolutions' epilogues on the TPU.  PyTorch's eager mode does not, so on
// the card the same module ran as some 24 elementwise and reduction kernels
// forward and 20 backward, over f32 copies, and held 75-79% of the train
// step's device time.  These kernels take their place.
//
// What bounds them on an H100 SXM (3.35 TB/s, 50 MB L2).  Bytes: a few
// operations an element against 295 the card could do for each byte.  The
// least traffic is one read of x for the statistics, one read of x (and the
// residual) and one write of y for the output, and in backward two reads of
// x, dy and y and one write of dx (and d_residual): about 7 B an element
// forward and 15 B backward in bf16.
//
// Design.
//  * Four kernels, each one pass: css_bn_stats (sums of x and x^2),
//    css_bn_apply (normalise, add, ReLU, write y), css_bn_grad_stats (sums of
//    g and g * xhat, the weight and bias gradients), css_bn_grad_apply (dx
//    and d_residual).  css_bn_finish turns all-reduced sums into statistics
//    where the sums cross replicas first.
//  * A block is 8 threads across a tile of channels by 32 rows.  Each thread
//    takes V channels with one 16-byte load (8 bf16 or 4 f32; one element
//    where C or the row stride is not a multiple of that), so a warp reads
//    four rows of 128 contiguous bytes.  Each thread issues several rows'
//    loads before it uses them, to keep enough bytes in flight.
//  * The grid is channel tiles x (groups x chunks of rows); the wrapper sizes
//    the chunks to about four blocks an SM.  The apply kernels walk the same
//    grid as their statistics kernels, right after them, so a BN input that
//    fits the L2 is read from it the second time.
//  * The statistics kernels write each block's sums to scratch; the last
//    block of a channel tile (a ticket counter, reset by that block) adds
//    them in chunk order and finishes the tile: statistics and running stats
//    in forward, the sums of g and g * xhat and dw, db in backward.  No
//    floating-point atomics, so two runs give identical bits.
//  * All arithmetic in f32; y and dx are rounded once, to the input's type.
// The kernels launch on the caller's stream, never synchronise and allocate
// nothing; the caller passes outputs and scratch, and the ticket counters
// (zero, and left zero) of one stream at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Every pointer and size of one launch.  `sums` and `stat` are [2][groups][C]
// f32: (sum x, sum x^2) or (sum g, sum g * xhat), and (mean, rstd).  Rows of
// `out`, `dres` and the saved `y` are C wide.  Mirrors `_Args` in
// css_tpu_torch/ops/kernels/batchnorm_kernels.py field for field.
struct BnArgs {
  const void* x;
  long long ldx;
  const void* res;          // residual or null (apply)
  long long ldr;
  const void* dy;           // backward
  long long ldd;
  const void* y;            // the forward's output where a ReLU follows, else null (backward)
  void* out;                // y (apply) or dx (grad_apply)
  void* dres;               // d_residual or null (grad_apply)
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  float* partial;           // [groups * chunks][2][C] scratch
  float* sums;
  float* stat;
  float* dweight;
  float* dbias;
  int* tickets;             // [channel tiles]
  long long rows_per_group;
  long long rows_per_chunk;
  int C;
  int groups;
  int chunks;
  int relu;
  int finish;               // css_bn_stats: finish the statistics too (no all-reduce between)
  int update;               // move the running stats
  float n;                  // rows a group's statistics count (every replica's)
  float eps;
  float momentum;           // the running stats keep this share
  float keep;               // 1 - momentum, rounded from double as the reference's is
  float bessel;             // n / (n - 1)
};

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 8;                  // threads across a tile's channels
constexpr int kTy = kThreads / kTx;     // rows at a time
constexpr int kMaxVec = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive channels as floats: one 16-byte access, or one element.
template <typename T, int V> struct Io;

template <> struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <> struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T> struct Io<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&f)[1]) { f[0] = to_f(p[0]); }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) { p[0] = from_f<T>(f[0]); }
};

// The rows of this block: [r0, r1) of group g.
struct Span {
  long long r0, r1;
  int g;
};

__device__ __forceinline__ Span block_rows(const BnArgs& a) {
  const int g = blockIdx.y / a.chunks, k = blockIdx.y % a.chunks;
  const long long start = g * a.rows_per_group + k * a.rows_per_chunk;
  const long long end = min(start + a.rows_per_chunk, (g + 1) * a.rows_per_group);
  return {start, end, g};
}

// The block's two sums of its tile's channels -> partial[blockIdx.y], added
// over the block's rows in a fixed order.
template <int V>
__device__ void write_partial(const BnArgs& a, int tile, const float (&s1)[V],
                              const float (&s2)[V]) {
  constexpr int kTw = kTx * V;
  __shared__ float red[2][kTy][kTx * kMaxVec];
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][ty][tx * V + j] = s1[j];
    red[1][ty][tx * V + j] = s2[j];
  }
  __syncthreads();
  float* part = a.partial + static_cast<size_t>(blockIdx.y) * 2 * a.C;
  for (int i = threadIdx.x; i < 2 * kTw; i += kThreads) {
    const int q = i / kTw, cl = i % kTw, c = tile * kTw + cl;
    float t = 0.f;
    for (int k = 0; k < kTy; ++k) t += red[q][k][cl];
    if (c < a.C) part[static_cast<size_t>(q) * a.C + c] = t;
  }
}

// True in the last block of the channel tile to finish its partials.
__device__ bool last_block(int* ticket) {
  __shared__ int is_last;
  __threadfence();            // this block's partials, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// Group gg's two sums of channel tile*kTw + threadIdx.x over every chunk, in
// chunk order, valid in threads threadIdx.x < kTw.  Every thread calls it.
template <int kTw>
__device__ void tile_sums(const BnArgs& a, int tile, int gg, float& s1, float& s2) {
  constexpr int kParts = kThreads / kTw;
  __shared__ float fin[2][kThreads];
  const int cl = threadIdx.x % kTw, part = threadIdx.x / kTw, c = tile * kTw + cl;
  float t1 = 0.f, t2 = 0.f;
  if (c < a.C) {
#pragma unroll 4
    for (int k = part; k < a.chunks; k += kParts) {
      const float* p = a.partial + static_cast<size_t>(gg * a.chunks + k) * 2 * a.C + c;
      t1 += __ldcg(p);
      t2 += __ldcg(p + a.C);
    }
  }
  fin[0][threadIdx.x] = t1;
  fin[1][threadIdx.x] = t2;
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
  if (part == 0) {
    for (int p = 0; p < kParts; ++p) {
      s1 += fin[0][p * kTw + cl];
      s2 += fin[1][p * kTw + cl];
    }
  }
  __syncthreads();            // fin is reused by the next group
}

// Statistics of group gg, channel c, from its sums; the running stats rm, rv
// move once (group 0 first, as the caller loops).
__device__ __forceinline__ void finish_channel(const BnArgs& a, int c, int gg, float s1,
                                               float s2, float& rm, float& rv) {
  const float mean = __fdiv_rn(s1, a.n);
  const float var = __fsub_rn(__fdiv_rn(s2, a.n), __fmul_rn(mean, mean));
  a.stat[gg * a.C + c] = mean;
  a.stat[(a.groups + gg) * a.C + c] = rsqrtf(__fadd_rn(var, a.eps));
  rm = __fadd_rn(__fmul_rn(a.momentum, rm), __fmul_rn(a.keep, mean));
  rv = __fadd_rn(__fmul_rn(a.momentum, rv), __fmul_rn(__fmul_rn(a.keep, var), a.bessel));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) css_bn_stats_kernel(const BnArgs a) {
  constexpr int kTw = kTx * V, kUnroll = 4;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx, tile = blockIdx.x;
  const int c0 = tile * kTw + tx * V;
  const Span s = block_rows(a);
  const T* x = static_cast<const T*>(a.x) + c0;
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  if (c0 < a.C) {
    long long r = s.r0 + ty;
    for (; r + (kUnroll - 1) * kTy < s.r1; r += kUnroll * kTy) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) Io<T, V>::load(x + (r + u * kTy) * a.ldx, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += v[u][j];
          s2[j] = fmaf(v[u][j], v[u][j], s2[j]);
        }
      }
    }
    for (; r < s.r1; r += kTy) {
      float v[V];
      Io<T, V>::load(x + r * a.ldx, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += v[j];
        s2[j] = fmaf(v[j], v[j], s2[j]);
      }
    }
  }
  write_partial<V>(a, tile, s1, s2);
  if (!last_block(a.tickets + tile)) return;
  const int c = tile * kTw + threadIdx.x;
  const bool lead = threadIdx.x < kTw && c < a.C;
  float rm = 0.f, rv = 0.f;
  if (lead && a.finish) {
    rm = a.running_mean[c];
    rv = a.running_var[c];
  }
  for (int gg = 0; gg < a.groups; ++gg) {
    float t1, t2;
    tile_sums<kTw>(a, tile, gg, t1, t2);
    if (lead) {
      a.sums[gg * a.C + c] = t1;
      a.sums[(a.groups + gg) * a.C + c] = t2;
      if (a.finish) finish_channel(a, c, gg, t1, t2, rm, rv);
    }
  }
  if (lead && a.finish && a.update) {
    a.running_mean[c] = rm;
    a.running_var[c] = rv;
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0;
}

// The statistics from all-reduced sums: one thread a channel.
__global__ void __launch_bounds__(kThreads) css_bn_finish_kernel(const BnArgs a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.C) return;
  float rm = a.running_mean[c], rv = a.running_var[c];
  for (int gg = 0; gg < a.groups; ++gg) {
    finish_channel(a, c, gg, a.sums[gg * a.C + c], a.sums[(a.groups + gg) * a.C + c], rm, rv);
  }
  if (a.update) {
    a.running_mean[c] = rm;
    a.running_var[c] = rv;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) css_bn_apply_kernel(const BnArgs a) {
  constexpr int kTw = kTx * V, kUnroll = 4;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int c0 = blockIdx.x * kTw + tx * V;
  if (c0 >= a.C) return;
  const Span s = block_rows(a);
  float mean[V], inv[V], bias[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = a.stat[s.g * a.C + c0 + j];
    inv[j] = __fmul_rn(a.weight[c0 + j], a.stat[(a.groups + s.g) * a.C + c0 + j]);
    bias[j] = a.bias[c0 + j];
  }
  const T* x = static_cast<const T*>(a.x) + c0;
  const T* res = a.res ? static_cast<const T*>(a.res) + c0 : nullptr;
  T* y = static_cast<T*>(a.out) + c0;
  const bool has_res = a.res != nullptr;
  auto one = [&](long long r, const float (&v)[V], const float (&w)[V]) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float t = (v[j] - mean[j]) * inv[j] + bias[j];
      if (has_res) t += w[j];
      o[j] = a.relu && t < 0.f ? 0.f : t;
    }
    Io<T, V>::store(y + r * a.C, o);
  };
  long long r = s.r0 + ty;
  for (; r + (kUnroll - 1) * kTy < s.r1; r += kUnroll * kTy) {
    float v[kUnroll][V], w[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Io<T, V>::load(x + (r + u * kTy) * a.ldx, v[u]);
      if (has_res) Io<T, V>::load(res + (r + u * kTy) * a.ldr, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(r + u * kTy, v[u], w[u]);
  }
  for (; r < s.r1; r += kTy) {
    float v[V], w[V];
    Io<T, V>::load(x + r * a.ldx, v);
    if (has_res) Io<T, V>::load(res + r * a.ldr, w);
    one(r, v, w);
  }
}

// g for V channels of row r: dy, zero where the saved output is not positive.
template <typename T, int V>
__device__ __forceinline__ void load_g(const BnArgs& a, const T* dy, const T* y, long long r,
                                       float (&g)[V]) {
  Io<T, V>::load(dy + r * a.ldd, g);
  if (a.relu) {
    float o[V];
    Io<T, V>::load(y + r * a.C, o);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = o[j] > 0.f ? g[j] : 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) css_bn_grad_stats_kernel(const BnArgs a) {
  constexpr int kTw = kTx * V, kUnroll = 2;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx, tile = blockIdx.x;
  const int c0 = tile * kTw + tx * V;
  const Span s = block_rows(a);
  const T* x = static_cast<const T*>(a.x) + c0;
  const T* dy = static_cast<const T*>(a.dy) + c0;
  const T* y = a.y ? static_cast<const T*>(a.y) + c0 : nullptr;
  float sg[V], sgx[V], mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = mean[j] = 0.f;
  if (c0 < a.C) {
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = a.stat[s.g * a.C + c0 + j];
    long long r = s.r0 + ty;
    for (; r + (kUnroll - 1) * kTy < s.r1; r += kUnroll * kTy) {
      float v[kUnroll][V], g[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Io<T, V>::load(x + (r + u * kTy) * a.ldx, v[u]);
        load_g<T, V>(a, dy, y, r + u * kTy, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sg[j] += g[u][j];
          sgx[j] = fmaf(g[u][j], v[u][j] - mean[j], sgx[j]);
        }
      }
    }
    for (; r < s.r1; r += kTy) {
      float v[V], g[V];
      Io<T, V>::load(x + r * a.ldx, v);
      load_g<T, V>(a, dy, y, r, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] += g[j];
        sgx[j] = fmaf(g[j], v[j] - mean[j], sgx[j]);
      }
    }
  }
  write_partial<V>(a, tile, sg, sgx);
  if (!last_block(a.tickets + tile)) return;
  const int c = tile * kTw + threadIdx.x;
  const bool lead = threadIdx.x < kTw && c < a.C;
  float dw = 0.f, db = 0.f;
  for (int gg = 0; gg < a.groups; ++gg) {
    float t1, t2;
    tile_sums<kTw>(a, tile, gg, t1, t2);
    if (lead) {
      const float gx = t2 * a.stat[(a.groups + gg) * a.C + c];   // sum g * xhat
      a.sums[gg * a.C + c] = t1;
      a.sums[(a.groups + gg) * a.C + c] = gx;
      dw += gx;
      db += t1;
    }
  }
  if (lead) {
    a.dweight[c] = dw;
    a.dbias[c] = db;
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) css_bn_grad_apply_kernel(const BnArgs a) {
  constexpr int kTw = kTx * V, kUnroll = 2;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int c0 = blockIdx.x * kTw + tx * V;
  if (c0 >= a.C) return;
  const Span s = block_rows(a);
  // dx = inv * (g - mg - (x - mean) * k): inv = w * rstd, mg = sum(g) / n,
  // k = rstd * sum(g * xhat) / n
  float mean[V], inv[V], mg[V], k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    const float rstd = a.stat[(a.groups + s.g) * a.C + c];
    mean[j] = a.stat[s.g * a.C + c];
    inv[j] = a.weight[c] * rstd;
    mg[j] = a.sums[s.g * a.C + c] / a.n;
    k[j] = rstd * (a.sums[(a.groups + s.g) * a.C + c] / a.n);
  }
  const T* x = static_cast<const T*>(a.x) + c0;
  const T* dy = static_cast<const T*>(a.dy) + c0;
  const T* y = a.y ? static_cast<const T*>(a.y) + c0 : nullptr;
  T* dx = static_cast<T*>(a.out) + c0;
  T* dres = a.dres ? static_cast<T*>(a.dres) + c0 : nullptr;
  const bool has_dres = a.dres != nullptr;
  auto one = [&](long long r, const float (&v)[V], const float (&g)[V]) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = inv[j] * (g[j] - mg[j] - (v[j] - mean[j]) * k[j]);
    Io<T, V>::store(dx + r * a.C, o);
    if (has_dres) Io<T, V>::store(dres + r * a.C, g);
  };
  long long r = s.r0 + ty;
  for (; r + (kUnroll - 1) * kTy < s.r1; r += kUnroll * kTy) {
    float v[kUnroll][V], g[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Io<T, V>::load(x + (r + u * kTy) * a.ldx, v[u]);
      load_g<T, V>(a, dy, y, r + u * kTy, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(r + u * kTy, v[u], g[u]);
  }
  for (; r < s.r1; r += kTy) {
    float v[V], g[V];
    Io<T, V>::load(x + r * a.ldx, v);
    load_g<T, V>(a, dy, y, r, g);
    one(r, v, g);
  }
}

template <typename T, int V>
int launch(void (*kernel)(BnArgs), const BnArgs& a, cudaStream_t stream) {
  const dim3 grid((a.C + kTx * V - 1) / (kTx * V), a.groups * a.chunks);
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const BnArgs* a) {
  return a != nullptr && a->C > 0 && a->groups > 0 && a->chunks > 0 && a->rows_per_group >= 0 &&
         a->rows_per_chunk > 0 && a->rows_per_chunk * a->chunks >= a->rows_per_group &&
         static_cast<long long>(a->groups) * a->chunks <= 65535;
}

}  // namespace

// Each entry: `args` as above, bf16 (1) or f32 (0) tensors, vec (1) for
// 16-byte accesses (C, every row stride and every pointer a multiple of 16
// bytes) or (0) one element a thread.  Returns a cudaError_t.
#define CSS_BN_ENTRY(name, kernel)                                                            \
  extern "C" int name(const BnArgs* args, int bf16, int vec, void* stream) {                 \
    if (!valid(args)) return static_cast<int>(cudaErrorInvalidValue);                         \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                       \
    if (bf16) {                                                                               \
      return vec ? launch<__nv_bfloat16, 8>(kernel<__nv_bfloat16, 8>, *args, s)               \
                 : launch<__nv_bfloat16, 1>(kernel<__nv_bfloat16, 1>, *args, s);              \
    }                                                                                         \
    return vec ? launch<float, 4>(kernel<float, 4>, *args, s)                                 \
               : launch<float, 1>(kernel<float, 1>, *args, s);                                \
  }

// x -> partial, sums; with args->finish also stat and the running stats.
CSS_BN_ENTRY(css_bn_stats, css_bn_stats_kernel)
// x, stat, weight, bias [, res] -> out (y).
CSS_BN_ENTRY(css_bn_apply, css_bn_apply_kernel)
// x, dy [, y], stat -> partial, sums (sum g, sum g * xhat), dweight, dbias.
CSS_BN_ENTRY(css_bn_grad_stats, css_bn_grad_stats_kernel)
// x, dy [, y], stat, weight, sums -> out (dx) [, dres].
CSS_BN_ENTRY(css_bn_grad_apply, css_bn_grad_apply_kernel)

// sums (all-reduced) -> stat and the running stats.
extern "C" int css_bn_finish(const BnArgs* args, void* stream) {
  if (!valid(args)) return static_cast<int>(cudaErrorInvalidValue);
  css_bn_finish_kernel<<<(args->C + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
