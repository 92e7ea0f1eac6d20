// GroupNorm fused with the ReLU that follows it, for Hopper (sm_90a): two
// kernels behind a plain C interface, loaded with ctypes by
// repro_torch/kernels/build.py.
//
//   K9 group_norm_relu_stats, group_norm_relu_apply: they replace no Pallas
//   kernel.  The reference leaves GroupNorm to XLA
//   (src/repro/models/layers.py groupnorm_apply); the port's CNN segments
//   called ATen's F.group_norm and then F.relu, and ATen reduces each
//   (image, group) row in one block of 512 threads: 16 blocks for a
//   hospital's batch of 2 in the U-Net's front at 768^2 x 64, on a card of
//   132 SMs, each thread with one load in flight.
//
// A channels_last x is first copied to NCHW, as ATen copies it, by a third
// kernel, group_norm_to_nchw (32 x 32 tiles through shared memory, where
// ATen's strided elementwise copy reads the card at about 4% of its
// bandwidth), and the backward reads that copy, as ATen's does.
//
// What they compute, for x (N, C, H, W) NCHW-contiguous, C channels in G
// groups of Cg = C / G, a row (n, g) of L = Cg * H * W elements:
//   mean[n, g], rstd[n, g] = 1 / sqrt(var + eps), var biased
//   y[n, c, hw] = relu(x * a[n, c] + b[n, c]),  a = rstd * gamma[c],
//                 b = beta[c] - mean * a        (NCHW-contiguous, x's type)
// in f32 (bf16 x is read as f32 and y rounded once to bf16).
//
// In ATen's arithmetic, to the bit: the U-Net's and DenseNet's fronts feed
// the int8 cut-layer link, where one ulp of an activation can move it to
// the next level, so a GroupNorm that rounds otherwise than ATen's (even
// more exactly) parts the first step's losses from the float32
// reference's.  ATen's RowwiseMomentsCUDAKernel runs 512 Welford chains a
// row (32 when L < 512): chain t takes elements t, t + 512, ... in order
// (f32 mean, M2 and count; an IEEE division a step), then each warp's 32
// chains are combined by a shfl_down tree, and the 16 warps' results by one
// more tree in the first warp; rstd is rsqrtf(M2 / count + eps).  Here the
// same chains, steps and trees give the same bits, but a row's 16 warps
// are 16 blocks of their own, spread over every SM, each chain keeps 32 to
// 64 loads in flight (ATen's keeps one: it waits on memory), and a step's
// division takes Markstein's correction of a reciprocal computed ahead
// (the same correctly rounded quotient, on a shorter path).  The apply
// merges a row's 16 warp results with ATen's second tree, and a, b and y
// are ATen's ComputeFusedParams and elementwise FMAs.
//
// Bound on this card: bytes.  x is read twice (the statistics, then the
// apply) and y written once: 12 bytes an f32 element, against the 8 a
// single pass would move; a row at 768^2 (up to 47 MB at batch 10) does not
// stay in the 50 MB L2 between the two passes.  The chains are a sequence
// of 9,216 dependent steps at 768^2 x 64 (about 25 cycles each), which
// bounds a hospital's 16-row front norms, not its bytes.
//
// Apply: each block first merges the warp results of the rows it touches,
// one warp a row, into mean and rstd, and a and b of each plane in shared
// memory; then takes a contiguous range of the output, which equals the
// input's, finding each vector's plane by stepping (no division in the
// loop).  The block holding a row's first element writes mean[n, g] and
// rstd[n, g] (every block computes the same values), which the backward
// reads.
//
// No atomics and a fixed order throughout: a launch gives the same bits
// every time, and nothing but the two kernels runs (scratch and outputs are
// the wrapper's torch.empty), so a CUDA graph captures them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // apply block
constexpr int kWarp = 32;
constexpr int kChains = 512;      // ATen's kCUDABlockReduceNumThreads
constexpr int kUnroll = 4;        // vectors in flight an apply thread
constexpr int kSpan = 16384;      // output elements of an apply block,
constexpr int kMinSpan = 1024;    // ... shorter for small tensors, so that
constexpr int kApplyPerSm = 8;    // about this many blocks a SM are launched
constexpr int kMaxPlanes = 2050;  // planes an apply block may touch
constexpr int kShortChains = 256; // steps under which a block takes 4 warps
constexpr int kTile = 32;         // channels and positions of a transpose tile
constexpr int kTileRows = 8;      // blockDim = (kTile, kTileRows)
constexpr int kTilesPerBlock = 8; // position tiles a transpose block walks

__device__ __forceinline__ float f32_of(float v) { return v; }
__device__ __forceinline__ float f32_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V adjacent elements at p (V = 4: one 16-byte f32 or 8-byte bf16 load)
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p[e];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __bfloat162float(p[e]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&lo);
    q.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// ReLU of ATen's elementwise a * x + b (one FMA), NaN passed on as
// torch.relu does
__device__ __forceinline__ float relu_affine(float v, float a, float b) {
  const float t = fmaf(a, v, b);
  return t < 0.f ? 0.f : t;
}

// ATen's WelfordData<float, int64_t> (its count n is nf here: a chain's
// n + 1 as a float is exact below 2^24) and WelfordOps, each rounding
// spelled out (fmaf where ATen's build fuses a product and a sum, __fmul_rn
// and __fadd_rn where it rounds both), so that no contraction of this
// build can part them
struct Welford {
  float mean, m2, nf;
};

__device__ __forceinline__ Welford welford_combine(Welford a, Welford b) {
  if (a.nf == 0) return b;
  if (b.nf == 0) return a;
  const float delta = b.mean - a.mean;
  const float new_count = a.nf + b.nf;
  const float nb_over_n = b.nf / new_count;
  return {fmaf(delta, nb_over_n, a.mean),
          fmaf(__fmul_rn(__fmul_rn(delta, delta), a.nf), nb_over_n,
               __fadd_rn(a.m2, b.m2)),
          new_count};
}

// ATen's WarpReduce: lane i takes lane i + offset's value, offsets 16 .. 1;
// lane 0 holds the result
__device__ __forceinline__ Welford warp_reduce(Welford v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const Welford o = {__shfl_down_sync(0xffffffffu, v.mean, off),
                       __shfl_down_sync(0xffffffffu, v.m2, off),
                       __shfl_down_sync(0xffffffffu, v.nf, off)};
    v = welford_combine(v, o);
  }
  return v;
}

// mean and rstd of rows r0 .. r0 + nr - 1 from their `warps` warp results
// (ATen's BlockReduce: the warps' results in lanes 0 .. warps - 1, empty
// ones above, one more WarpReduce), one warp a row, into rm[i], rr[i]
__device__ void row_stats(const float* __restrict__ partials, int warps,
                          long long r0, int nr, float eps, float* rm,
                          float* rr) {
  const int l = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int i = warp; i < nr; i += n_warps) {
    Welford v = {0.f, 0.f, 0.f};
    if (l < warps) {
      const float* p = partials + ((r0 + i) * warps + l) * 3;
      v = {p[0], p[1], p[2]};
    }
    v = warp_reduce(v);
    if (l == 0) {
      rm[i] = v.mean;
      rr[i] = rsqrtf(v.m2 / v.nf + eps);
    }
  }
}

// ---------------------------------------------------------------------------
// stats: warp u (one a block, or four where chains are short) runs ATen's
// chains 32 w .. 32 w + 31 of row u / warps, w = u % warps, with stride
// 32 * warps, and writes the warp's (mean, M2, count) to partials[3 u ..].
// A step divides by the count as Markstein does: with r = 1 / count
// correctly rounded (off the chain's path: the count is known ahead),
// q0 = delta r, then q0 + (delta - q0 count) r is the correctly rounded
// quotient, the bits of ATen's IEEE division for finite operands.
// ---------------------------------------------------------------------------

// kWarp elements of chain xc from step k0 on (0 past the chain's end)
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ xc,
                                           long long stride, long long count,
                                           long long k0, float (&buf)[kWarp]) {
#pragma unroll
  for (int i = 0; i < kWarp; ++i)
    buf[i] = k0 + i < count ? f32_of(xc[(k0 + i) * stride]) : 0.f;
}

// ATen's WelfordOps::reduce over steps k0 .. k0 + 31 of the chain; lane l
// takes 1 / (k0 + l + 1), the counts of the 32 steps, correctly rounded,
// and hands it to every lane at its step
__device__ __forceinline__ void reduce_steps(const float (&buf)[kWarp],
                                             long long count, long long k0,
                                             int lane, float& mean,
                                             float& m2, float& nf) {
  const float r_lane = __frcp_rn(static_cast<float>(k0 + lane + 1));
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    const float r = __shfl_sync(0xffffffffu, r_lane, i);
    if (k0 + i < count) {
      const float data = buf[i];
      const float new_nf = nf + 1.f;
      const float delta = data - mean;
      const float q0 = __fmul_rn(delta, r);
      const float q = fmaf(fmaf(-q0, new_nf, delta), r, q0);  // delta / new_nf
      const float new_mean = __fadd_rn(mean, q);
      const float new_delta = data - new_mean;
      m2 = fmaf(delta, new_delta, m2);
      mean = new_mean;
      nf = new_nf;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(4 * kWarp)
group_norm_stats(const T* __restrict__ x, long long len, int warps,
                 long long units, float* __restrict__ partials) {
  const long long u =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (u >= units) return;
  const int lane = threadIdx.x % kWarp;
  const long long row = u / warps;
  const long long stride = kWarp * warps;
  const long long t = (u % warps) * kWarp + lane;
  const T* xc = x + row * len + t;
  const long long count = t < len ? (len - t + stride - 1) / stride : 0;
  // lane 0's chain is the warp's longest: every lane steps to its end
  const long long steps = __shfl_sync(0xffffffffu, count, 0);
  float mean = 0.f, m2 = 0.f, nf = 0.f;
  // two buffers of 32 steps: one loads while the other is reduced, so a
  // load is consumed 32 to 64 steps after it was issued, and no register
  // waits on one in flight
  float a[kWarp], b[kWarp];
  load_steps(xc, stride, count, 0, a);
  for (long long k = 0; k < steps; k += 2 * kWarp) {
    load_steps(xc, stride, count, k + kWarp, b);
    reduce_steps(a, count, k, lane, mean, m2, nf);
    load_steps(xc, stride, count, k + 2 * kWarp, a);
    reduce_steps(b, count, k + kWarp, lane, mean, m2, nf);
  }
  const Welford v = warp_reduce({mean, m2, nf});
  if (lane == 0) {
    float* p = partials + u * 3;
    p[0] = v.mean;
    p[1] = v.m2;
    p[2] = v.nf;
  }
}

// ---------------------------------------------------------------------------
// apply: block b writes output elements [b * span, (b + 1) * span) (span a
// multiple of 4); plane p = n * c + ch holds hw elements, row p / cg.
// Shared memory: 4 * max_planes floats.
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_norm_relu_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ partials, int c, int hw,
                     int groups, int warps, int span, long long total,
                     int max_planes, float eps, T* __restrict__ y,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out) {
  extern __shared__ float fsm[];
  const long long start = static_cast<long long>(blockIdx.x) * span;
  const int len = static_cast<int>(start + span < total ? span : total - start);
  const long long p0 = start / hw, p1 = (start + len - 1) / hw;
  const int np = static_cast<int>(p1 - p0 + 1);
  const int cg = c / groups;
  const long long r0 = p0 / cg;
  const int nr = static_cast<int>(p1 / cg - r0 + 1);
  float* pa = fsm;
  float* pb = fsm + max_planes;
  float* rm = fsm + 2 * max_planes;
  float* rr = rm + max_planes;
  row_stats(partials, warps, r0, nr, eps, rm, rr);
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const long long p = p0 + i;
    const int ch = static_cast<int>(p % c);
    const int ri = static_cast<int>(p / cg - r0);
    // ATen's ComputeFusedParamsCUDAKernel: -scale * mean + beta is rounded
    // twice there (its y then matches ATen's on every element)
    const float scale = rr[ri] * gamma[ch];
    pa[i] = scale;
    pb[i] = __fadd_rn(__fmul_rn(-scale, rm[ri]), beta[ch]);
    if (ch % cg == 0 && p * hw >= start) {
      mean_out[p / cg] = rm[ri];
      rstd_out[p / cg] = rr[ri];
    }
  }
  __syncthreads();
  const T* xb = x + start;
  T* yb = y + start;
  const int step = V * kThreads;
  const int dq = step / hw, dr = step % hw;
  int o = V * threadIdx.x;
  const int rel = static_cast<int>(start - p0 * hw) + o;  // from plane p0
  int pi = rel / hw, w = rel % hw;                        // plane, position
  for (; o < len; o += kUnroll * step) {
    float v[kUnroll][V];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = pi;
      if (o + u * step < len) load_v<V>(xb + o + u * step, v[u]);
      pi += dq;
      w += dr;
      if (w >= hw) {
        w -= hw;
        ++pi;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (o + u * step < len) {
        const float a = pa[at[u]], b = pb[at[u]];
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] = relu_affine(v[u][e], a, b);
        store_v<V>(yb + o + u * step, out);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// channels_last x (n, hw, c) -> NCHW out (n, c, hw), the copy ATen's CUDA
// GroupNorm makes of such an input (through a strided elementwise copy):
// block (bx, by, n) moves channels [by * 32, by * 32 + 32) at positions
// [bx * 256, bx * 256 + 256), a 32 x 32 tile at a time through shared
// memory, reading along channels and writing along positions
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
group_norm_nchw_tiles(const T* __restrict__ x, int c, int hw,
                      T* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const long long n = blockIdx.z;
  const int c0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const T* xn = x + n * hw * c;
  T* on = out + n * c * hw;
  for (int k = 0; k < kTilesPerBlock; ++k) {
    const int h0 = (blockIdx.x * kTilesPerBlock + k) * kTile;
    if (h0 >= hw) break;                 // the same for the whole block
#pragma unroll
    for (int j = 0; j < kTile; j += kTileRows) {
      const int h = h0 + ty + j, ch = c0 + tx;
      if (h < hw && ch < c)
        tile[ty + j][tx] = f32_of(xn[static_cast<long long>(h) * c + ch]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile; j += kTileRows) {
      const int ch = c0 + ty + j, h = h0 + tx;
      if (h < hw && ch < c) {
        float v[1] = {tile[tx][ty + j]};
        store_v<1>(on + static_cast<long long>(ch) * hw + h, v);
      }
    }
    __syncthreads();
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int warps_of(long long len) { return len < kChains ? 1 : kChains / kWarp; }

template <typename T>
int launch_stats(const void* x, long long n, int c, long long hw, int groups,
                 void* partials, cudaStream_t st) {
  const long long len = static_cast<long long>(c / groups) * hw;
  const int warps = warps_of(len);
  const long long units = n * groups * warps;
  // a long chain a block, spread over every SM; short ones four a block
  const int per_block = len / (kWarp * warps) < kShortChains ? 4 : 1;
  group_norm_stats<T><<<static_cast<unsigned>((units + per_block - 1) /
                                              per_block),
                        kWarp * per_block, 0, st>>>(
      static_cast<const T*>(x), len, warps, units,
      static_cast<float*>(partials));
  return cudaGetLastError();
}

template <typename T>
int launch_nchw(const void* x, long long n, int c, long long hw, void* out,
                cudaStream_t st) {
  const int per_block = kTile * kTilesPerBlock;
  const dim3 grid(static_cast<unsigned>((hw + per_block - 1) / per_block),
                  static_cast<unsigned>((c + kTile - 1) / kTile),
                  static_cast<unsigned>(n));
  group_norm_nchw_tiles<T><<<grid, dim3(kTile, kTileRows), 0, st>>>(
      static_cast<const T*>(x), c, static_cast<int>(hw),
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int launch_apply(const void* xv, const void* gamma, const void* beta,
                 const void* partials, long long n, int c, long long hw,
                 int groups, float eps, void* yv, void* mean, void* rstd,
                 cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int warps = warps_of(static_cast<long long>(c / groups) * hw);
  // kSpan, or less where that leaves fewer than kApplyPerSm blocks a SM; a
  // block's span touches at most (span - 1) / hw + 2 planes, so small planes
  // shorten it until their a, b fit in shared memory
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = n * c * hw;
  const long long fill = static_cast<long long>(kApplyPerSm) * sms;
  long long span = ((total + fill - 1) / fill + 3) / 4 * 4;
  if (span > kSpan) span = kSpan;
  if (span < kMinSpan) span = kMinSpan;
  if (span > (kMaxPlanes - 2) * hw) span = (kMaxPlanes - 2) * hw / 4 * 4;
  if (span < 4) span = 4;
  const int max_planes = static_cast<int>((span - 1) / hw + 2);
  const unsigned blocks = static_cast<unsigned>((total + span - 1) / span);
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(max_planes);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* p = static_cast<const float*>(partials);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const int h = static_cast<int>(hw);
  if (hw % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T)))
    group_norm_relu_rows<T, 4><<<blocks, kThreads, smem, st>>>(
        x, g, b, p, c, h, groups, warps, static_cast<int>(span), total,
        max_planes, eps, y, m, r);
  else
    group_norm_relu_rows<T, 1><<<blocks, kThreads, smem, st>>>(
        x, g, b, p, c, h, groups, warps, static_cast<int>(span), total,
        max_planes, eps, y, m, r);
  return cudaGetLastError();
}

bool shape_ok(long long n, int c, long long hw, int groups) {
  return n >= 1 && c >= 1 && hw >= 1 && hw < (1LL << 30) && groups >= 1 &&
         c % groups == 0;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// x: (n, c, hw) NCHW-contiguous; dtype: 0 f32, 1 bf16.
extern "C" {

// x: (n, hw, c) channels_last -> out: (n, c, hw) NCHW-contiguous
int group_norm_to_nchw(const void* x, int dtype, long long n, int c,
                       long long hw, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, c, hw, 1) || n > 65535 || (c + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_nchw<float>(x, n, c, hw, out, st);
  if (dtype == 1) return launch_nchw<__nv_bfloat16>(x, n, c, hw, out, st);
  return cudaErrorInvalidValue;
}

// partials: n * groups * warps (mean, M2, count) f32 triples; warps is 16,
// or 1 where a row has fewer than 512 elements (ATen's chains)
int group_norm_relu_stats(const void* x, int dtype, long long n, int c,
                          long long hw, int groups, void* partials,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, c, hw, groups)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_stats<float>(x, n, c, hw, groups, partials, st);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, n, c, hw, groups, partials, st);
  return cudaErrorInvalidValue;
}

// gamma, beta: c f32; y: NCHW-contiguous, x's type; mean, rstd: n * groups
// f32
int group_norm_relu_apply(const void* x, const void* gamma, const void* beta,
                          const void* partials, int dtype, long long n, int c,
                          long long hw, int groups, float eps, void* y,
                          void* mean, void* rstd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(n, c, hw, groups)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_apply<float>(x, gamma, beta, partials, n, c, hw, groups,
                               eps, y, mean, rstd, st);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, gamma, beta, partials, n, c, hw,
                                       groups, eps, y, mean, rstd, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
