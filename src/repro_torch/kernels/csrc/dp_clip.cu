// DP-SGD per-example clip for Hopper (sm_90a): two kernels behind a plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py.
//
//   K5 dp_sqnorms      replaces src/repro/kernels/dp_clip/dp_clip.py
//                      sqnorms_pallas (_sqnorm_kernel)
//   K6 dp_scale_accum  replaces src/repro/kernels/dp_clip/dp_clip.py
//                      scale_accum_pallas (_scale_accum_kernel)
//
// What they compute over a hospital's per-example gradients, a list of L
// leaves, leaf l a contiguous (B, n_l) f32 matrix:
//   K5  sq[b]      = sum_l sum_j g_l[b, j]^2              (B,) f32
//   K6  out_l[j]   = sum_b s[b] * g_l[b, j]               one (n_l,) per leaf
// The reference launches each kernel once per leaf and sums K5's columns
// across leaves in jnp; DenseNet-121 has 364 leaves, so that would be 728
// launches per hospital and step.  Here each kernel launches once over a
// device-side table of the leaves, uploaded once for both: int64 rows of
// the L pointers, the L lengths, K5's chunk prefix sums (L + 1), the column
// prefix sums (L + 1) and K6's column-group prefix sums (L + 1; leaf l has
// ceil(n_l / 4) groups of 4 columns).
//
// Bound on this card: bytes.  Both read every gradient element once
// (16 x 6,948,609 f32 = 444.7 MB per hospital at 224^2, 0.133 ms at
// 3.35 TB/s); K6 also writes n = 27.8 MB.  Two flops per element.
//
// K5: pass 1 gives each block one chunk (`chunk` elements) of one
// example's row of one leaf; 256 threads stride over it (coalesced) and the
// block reduces to one partial.  Pass 2 gives each example one block that
// sums its partials.  Both passes sum in a fixed order and without atomics,
// so the result is the same in every run.  A block finds its leaf by
// binary search in the prefix sums once.
//
// K6, a streaming reduction: each thread owns a group of 4 adjacent
// columns of one leaf at a time and reads them as one 16-byte float4 per
// row, the rows unrolled by 8 (then a runtime tail), so 8 independent
// 16-byte loads are in flight per thread before any add; neighbouring
// threads take neighbouring groups, so a warp reads 512 contiguous bytes
// of a row.  The grid is sized by bytes, not by leaves: a grid-stride loop
// over all the groups of all the leaves (found by binary search in the
// group prefix sums), with about as many blocks as the card holds at once,
// so a one-element leaf costs one thread one group.  A leaf whose rows are
// not 16-byte aligned (length not a multiple of 4, or a misaligned start)
// takes the same loop with scalar loads; a group whose output is not
// 16-byte aligned is stored by scalars.  One pass, no atomics: every
// column is summed by one thread over b in order, the same in every run.
// Both kernels accumulate in double (the products of f32 values are exact
// in double, so K6's FMAs round only the sums) and round once to f32: the
// reference sums in f32 in another order, so the results agree to about
// 1e-7 relative, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// The largest l in [0, n) with prefix[l] <= i (prefix[0] = 0 <= i <
// prefix[n]); empty leaves (prefix[l] == prefix[l + 1]) are skipped.
__device__ __forceinline__ int find_leaf(const long long* prefix, int n,
                                         long long i) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (prefix[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// The block's sum, in thread 0, in a fixed order.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / kWarp ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = kThreads / kWarp / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// K5 reads the chunk prefix sums (leaf l has ceil(len / chunk) chunks,
// `chunks` in all per example); block = b * chunks + j
__global__ void sqnorm_partials(const long long* __restrict__ table, int n,
                                long long chunks, long long chunk,
                                double* __restrict__ partials) {
  const long long item = blockIdx.x;
  const long long b = item / chunks, j = item % chunks;
  const long long* lens = table + n;
  const long long* cprefix = table + 2 * n;
  const int l = find_leaf(cprefix, n, j);
  const long long len = lens[l];
  const float* g = reinterpret_cast<const float*>(table[l]) + b * len;
  const long long lo = (j - cprefix[l]) * chunk;
  const long long hi = lo + chunk < len ? lo + chunk : len;
  double acc = 0.0;
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
    const double v = g[k];
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[item] = acc;
}

__global__ void sqnorm_finish(const double* __restrict__ partials,
                              long long chunks, float* __restrict__ out) {
  const double* p = partials + blockIdx.x * chunks;
  double acc = 0.0;
  for (long long j = threadIdx.x; j < chunks; j += kThreads) acc += p[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = __double2float_rn(acc);
}

// K6's scalar path, for leaves whose rows are not 16-byte aligned: the
// group's `cnt` (1 to 4) columns from column `col` of row 0 at `g`
__device__ __forceinline__ void scale_accum_scalar(const float* __restrict__ g,
                                                   long long len, int batch,
                                                   const double* s, int cnt,
                                                   double (&acc)[4]) {
  int b = 0;
  for (; b + 8 <= batch; b += 8) {
    float x[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[u][c] = c < cnt ? __ldcs(g + (b + u) * len + c) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fma(s[b + u], (double)x[u][c], acc[c]);
  }
  for (; b < batch; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < cnt) acc[c] = fma(s[b], (double)__ldcs(g + b * len + c), acc[c]);
}

// K6's vector path: 4 columns as one float4 per row; `g` 16-byte aligned
// and `len` a multiple of 4
__device__ __forceinline__ void scale_accum_vec4(const float* __restrict__ g,
                                                 long long len, int batch,
                                                 const double* s,
                                                 double (&acc)[4]) {
  const float4* p = reinterpret_cast<const float4*>(g);
  const long long row = len / 4;  // float4 per row
  int b = 0;
  for (; b + 8 <= batch; b += 8) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __ldcs(p + (b + u) * row);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc[0] = fma(s[b + u], (double)x[u].x, acc[0]);
      acc[1] = fma(s[b + u], (double)x[u].y, acc[1]);
      acc[2] = fma(s[b + u], (double)x[u].z, acc[2]);
      acc[3] = fma(s[b + u], (double)x[u].w, acc[3]);
    }
  }
  for (; b < batch; ++b) {
    const float4 x = __ldcs(p + b * row);
    acc[0] = fma(s[b], (double)x.x, acc[0]);
    acc[1] = fma(s[b], (double)x.y, acc[1]);
    acc[2] = fma(s[b], (double)x.z, acc[2]);
    acc[3] = fma(s[b], (double)x.w, acc[3]);
  }
}

// K6 reads the group prefix sums for its items and the column prefix sums
// for where a leaf's sums go in out, the (sum n_l,) concatenation of the
// leaves' sums; `batch` scales as doubles in dynamic shared memory
__global__ void __launch_bounds__(kThreads)
scale_accum_kernel(const long long* __restrict__ table, int n, int batch,
                   long long groups, const float* __restrict__ scales,
                   float* __restrict__ out) {
  extern __shared__ double s[];
  for (int b = threadIdx.x; b < batch; b += kThreads) s[b] = scales[b];
  __syncthreads();
  const long long* lens = table + n;
  const long long* prefix = table + 3 * n + 1;
  const long long* gprefix = table + 4 * n + 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < groups; i += stride) {
    const int l = find_leaf(gprefix, n, i);
    const long long len = lens[l];
    const long long col = 4 * (i - gprefix[l]);
    const float* g = reinterpret_cast<const float*>(table[l]);
    const int cnt = len - col < 4 ? static_cast<int>(len - col) : 4;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    if ((len & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0)
      scale_accum_vec4(g + col, len, batch, s, acc);
    else
      scale_accum_scalar(g + col, len, batch, s, cnt, acc);
    float* o = out + prefix[l] + col;
    if (cnt == 4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(__double2float_rn(acc[0]), __double2float_rn(acc[1]),
                      __double2float_rn(acc[2]), __double2float_rn(acc[3]));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < cnt) o[c] = __double2float_rn(acc[c]);
    }
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
extern "C" {

// K5: partials is scratch of batch * chunks doubles; out is (batch,) f32.
int dp_sqnorms(const void* table, int n_leaves, int batch, long long chunks,
               long long chunk, void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || batch < 1 || chunks < 1 || chunk < 1)
    return cudaErrorInvalidValue;
  sqnorm_partials<<<static_cast<unsigned>(batch * chunks), kThreads, 0, st>>>(
      static_cast<const long long*>(table), n_leaves, chunks, chunk,
      static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sqnorm_finish<<<batch, kThreads, 0, st>>>(
      static_cast<const double*>(partials), chunks, static_cast<float*>(out));
  return cudaGetLastError();
}

// K6: scales is (batch,) f32; out is (sum of lengths,) f32; groups is the
// last entry of the table's group prefix sums.
int dp_scale_accum(const void* table, int n_leaves, int batch, long long groups,
                   const void* scales, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(double) * static_cast<size_t>(batch);
  if (n_leaves < 1 || batch < 1 || groups < 1 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scale_accum_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  // as many blocks as the SMs hold at once (one wave); more add nothing
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  scale_accum_kernel<<<static_cast<unsigned>(want < fill ? want : fill), kThreads,
                       smem, st>>>(
      static_cast<const long long*>(table), n_leaves, batch, groups,
      static_cast<const float*>(scales), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
