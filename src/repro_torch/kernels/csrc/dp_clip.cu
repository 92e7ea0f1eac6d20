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
// the L pointers, the L lengths, K5's chunk prefix sums (L + 1) and K6's
// column prefix sums (L + 1).
//
// Bound on this card: bytes.  Both read every gradient element once
// (16 x 6,948,609 f32 = 444.7 MB per hospital at 224^2, 0.133 ms at
// 3.35 TB/s); K6 also writes n = 27.8 MB.  Two flops per element.
//
// Design.  K5: pass 1 gives each block one chunk (`chunk` elements) of one
// example's row of one leaf; 256 threads stride over it (coalesced) and the
// block reduces to one partial.  Pass 2 gives each example one block that
// sums its partials.  Both passes sum in a fixed order and without atomics,
// so the result is the same in every run.  K6 takes the same chunks of
// columns, one block each: every thread owns a column at a time and loops
// over the B rows, so each warp's loads are consecutive.  A block finds its
// leaf by binary search in the prefix sums once.
// Both accumulate in double (the products of f32 values are exact in
// double) and round once to f32: the reference sums in f32 in another
// order, so the results agree to about 1e-7 relative, not bit for bit.
// 16-byte loads are left for later work.

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

// K6 reads the chunk prefix sums for its grid (block = j) and the column
// prefix sums for where a leaf's sums go in out, the (sum n_l,)
// concatenation of the leaves' sums
__global__ void scale_accum_kernel(const long long* __restrict__ table, int n,
                                   int batch, long long chunk,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out) {
  const long long* lens = table + n;
  const long long* cprefix = table + 2 * n;
  const long long* prefix = table + 3 * n + 1;
  const long long j = blockIdx.x;
  const int l = find_leaf(cprefix, n, j);
  const long long len = lens[l];
  const float* g = reinterpret_cast<const float*>(table[l]);
  float* o = out + prefix[l];
  const long long lo = (j - cprefix[l]) * chunk;
  const long long hi = lo + chunk < len ? lo + chunk : len;
  for (long long col = lo + threadIdx.x; col < hi; col += kThreads) {
    double acc = 0.0;
    for (int b = 0; b < batch; ++b)
      acc += (double)scales[b] * (double)g[b * len + col];
    o[col] = __double2float_rn(acc);
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

// K6: scales is (batch,) f32; out is (sum of lengths,) f32.
int dp_scale_accum(const void* table, int n_leaves, int batch, long long chunks,
                   long long chunk, const void* scales, void* out,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || batch < 1 || chunks < 1 || chunk < 1)
    return cudaErrorInvalidValue;
  scale_accum_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(
      static_cast<const long long*>(table), n_leaves, batch, chunk,
      static_cast<const float*>(scales), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
