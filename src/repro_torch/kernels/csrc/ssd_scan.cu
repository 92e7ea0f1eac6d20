// Mamba2 SSD chunk-local compute for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes by repro_torch/kernels/build.py.
//
//   K8 ssd_chunk_fwd  replaces src/repro/kernels/ssd_scan/ssd_scan.py
//                     ssd_chunk_kernel (_kernel)
//
// What it computes, for every batch b, chunk c and head h (B and C are read
// at group g = h / rep), over the chunk's q rows:
//   cs      = cumsum(la)                                 (q,)
//   L[i,j]  = exp(cs_i - cs_j) for j <= i, else 0        (q, q)
//   y_intra = ((C B^T) o L) xbar                          (q, p)
//   dte     = exp(cs_last - cs),  dfs = exp(cs)          (q,)
//   state   = (B o dte)^T xbar                            (n, p)
// xbar and la are f32; B and C are f32 or bf16 (the model passes bf16) and
// are read in their own type; every product and sum is f32 (expf, no fast
// math), so the kernel differs from the plain version only in summation
// order.  Outputs: y_intra (b, nc, q, h, p), states (b, nc, h, n, p), dte
// and dfs (b, nc, q, h), all f32 and contiguous.  Inputs are read by the
// strides of every axis (B and C are column slices of the conv output in
// the model, whose layout the einsum before them chooses).
//
// Bound on this card: at the scoring shape (b 4, nc 16, q 128, h 24, p 64,
// g 1, n 128, bf16 B/C) the function moves 157.5 MB (xbar, y_intra and the
// states 50.3 MB each; la, B, C, dte, dfs the rest): 0.047 ms at 3.35 TB/s.
// Its lower-triangular products need 3.24e9 flops on bf16 operands (C B^T)
// and 4.84e9 on f32 ones (with L and xbar): 0.0033 ms at 989 TFLOP/s plus
// 0.072 ms at 67 TFLOP/s.  So the bound is operations, unless the f32
// products were allowed TF32 tensor cores.
//
// Design, simple and right first.  One block of 256 threads per (h, c, b).
// C^T, B^T (n x q) and xbar (q x p) are staged in shared memory as f32; a
// single thread takes the chunk's cumsum in order.  Each product is tiled
// 4 x 4 per thread in registers, with float4 reads of shared memory:
//   1. S = C B^T over the tiles on or below the diagonal, held in registers
//      (up to four tiles a thread) until every read of C^T is done;
//   2. M^T[j, i] = S[i, j] exp(cs_i - cs_j) (0 above the diagonal) is written
//      over C^T's buffer;
//   3. y_intra = M xbar, each row tile stopping at the diagonal;
//   4. state = (B o dte)^T xbar.
// At q = n = 128, p = 64 the block takes 161 KB of dynamic shared memory,
// so one block runs per SM; CUDA-core f32 FMAs, no tensor cores.  Staging
// B^T and C^T writes shared memory with bank conflicts.  Tensor-core tiles
// and more blocks per SM are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;  // 4 x 4 tiles per thread: 128 x 128 / 16 / 256
enum DType : int { kF32 = 0, kBF16 = 1 };

struct Params {
  const float* x;   // xbar (b, nc, q, h, p)
  const float* la;  // (b, nc, q, h)
  const void* B;    // (b, nc, q, g, n)
  const void* C;
  float* y;         // (b, nc, q, h, p)
  float* st;        // (b, nc, h, n, p)
  float* dte;       // (b, nc, q, h)
  float* dfs;
  long long sx[5], sla[4], sb[5], sc[5];  // element strides of every axis
  int nc, q, h, p, rep, n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void outer(float (&a)[16], float4 u, float4 w) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[4 * r + c] = fmaf(uu[r], ww[c], a[4 * r + c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int q = P.q, n = P.n, p = P.p;
  float* ct = sm;                        // C^T (n x q), then M^T (q x q)
  float* bt = ct + max(n, q) * q;        // B^T (n x q)
  float* xs = bt + n * q;                // xbar (q x p)
  float* cs = xs + q * p;                // (q,)
  float* dte = cs + q;                   // (q,)

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, g = h / P.rep;
  const int tid = threadIdx.x;
  const float* xg = P.x + b * P.sx[0] + c * P.sx[1] + h * P.sx[3];
  const float* lag = P.la + b * P.sla[0] + c * P.sla[1] + h * P.sla[3];
  const T* bg = static_cast<const T*>(P.B) + b * P.sb[0] + c * P.sb[1] + g * P.sb[3];
  const T* cg = static_cast<const T*>(P.C) + b * P.sc[0] + c * P.sc[1] + g * P.sc[3];

  for (int e = tid; e < q * n; e += kThreads) {
    const int i = e / n, k = e % n;
    ct[k * q + i] = to_f(cg[i * P.sc[2] + k * P.sc[4]]);
    bt[k * q + i] = to_f(bg[i * P.sb[2] + k * P.sb[4]]);
  }
  for (int e = tid; e < q * p; e += kThreads) {
    const int i = e / p, j = e % p;
    xs[e] = xg[i * P.sx[2] + j * P.sx[4]];
  }
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += lag[i * P.sla[2]];
      cs[i] = run;
    }
  }
  __syncthreads();

  // decay vectors: (b, nc, q, h) contiguous
  const float total = cs[q - 1];
  for (int i = tid; i < q; i += kThreads) {
    const float d = expf(total - cs[i]);
    dte[i] = d;
    const long long o = ((static_cast<long long>(b) * P.nc + c) * q + i) * P.h + h;
    P.dte[o] = d;
    P.dfs[o] = expf(cs[i]);
  }

  // 1. S = C B^T, tiles on or below the diagonal
  const int tq = q / 4;
  float s[kSlots][16];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
    for (int r = 0; r < 16; ++r) s[sl][r] = 0.f;
    const int t = tid + kThreads * sl;
    if (t < tq * tq && t % tq <= t / tq) {
      const int i4 = 4 * (t / tq), j4 = 4 * (t % tq);
      for (int k = 0; k < n; ++k)
        outer(s[sl], *reinterpret_cast<const float4*>(ct + k * q + i4),
              *reinterpret_cast<const float4*>(bt + k * q + j4));
    }
  }
  __syncthreads();  // C^T is read for the last time; M^T takes its place

  // 2. M^T[j, i] = S[i, j] * L[i, j]
  float* mt = ct;
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int t = tid + kThreads * sl;
    if (t >= tq * tq) continue;
    const int i4 = 4 * (t / tq), j4 = 4 * (t % tq);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = i4 + r, j = j4 + cc;
        mt[j * q + i] = j <= i ? s[sl][4 * r + cc] * expf(cs[i] - cs[j]) : 0.f;
      }
  }
  __syncthreads();

  // 3. y_intra = M xbar; row tile i4 needs the keys j < i4 + 4 only
  const int tp = p / 4;
  for (int t = tid; t < tq * tp; t += kThreads) {
    const int i4 = 4 * (t / tp), p4 = 4 * (t % tp);
    float a[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) a[r] = 0.f;
    for (int j = 0; j < i4 + 4; ++j)
      outer(a, *reinterpret_cast<const float4*>(mt + j * q + i4),
            *reinterpret_cast<const float4*>(xs + j * p + p4));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long o =
          (((static_cast<long long>(b) * P.nc + c) * q + i4 + r) * P.h + h) * p + p4;
      *reinterpret_cast<float4*>(P.y + o) =
          make_float4(a[4 * r], a[4 * r + 1], a[4 * r + 2], a[4 * r + 3]);
    }
  }

  // 4. state = (B o dte)^T xbar
  const int tn = n / 4;
  for (int t = tid; t < tn * tp; t += kThreads) {
    const int k4 = 4 * (t / tp), p4 = 4 * (t % tp);
    float a[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) a[r] = 0.f;
    for (int i = 0; i < q; ++i) {
      const float d = dte[i];
      const float4 bd = make_float4(bt[k4 * q + i] * d, bt[(k4 + 1) * q + i] * d,
                                    bt[(k4 + 2) * q + i] * d, bt[(k4 + 3) * q + i] * d);
      outer(a, bd, *reinterpret_cast<const float4*>(xs + i * p + p4));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long o =
          (((static_cast<long long>(b) * P.nc + c) * P.h + h) * n + k4 + r) * p + p4;
      *reinterpret_cast<float4*>(P.st + o) =
          make_float4(a[4 * r], a[4 * r + 1], a[4 * r + 2], a[4 * r + 3]);
    }
  }
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t st) {
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(max(p.n, p.q)) * p.q +
                       static_cast<size_t>(p.n) * p.q +
                       static_cast<size_t>(p.q) * p.p + 2 * p.q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<dim3(p.h, p.nc, batch), kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: b, nc, q, h, p, g, n, then the element strides of xbar (5), la
// (4), B (5) and C (5): 26 values, host memory.  The outputs are
// contiguous.
// Launches on `stream` and returns cudaGetLastError(); an unknown dtype code
// returns cudaErrorInvalidValue without launching.  The wrapper checks
// q, n, p <= 128, each a multiple of 4, and h % g == 0.
int ssd_chunk_fwd(const void* xbar, const void* la, const void* B,
                  const void* C, void* y, void* states, void* dte, void* dfs,
                  const long long* dims, int dtype, void* stream) {
  Params p;
  p.x = static_cast<const float*>(xbar);
  p.la = static_cast<const float*>(la);
  p.B = B;
  p.C = C;
  p.y = static_cast<float*>(y);
  p.st = static_cast<float*>(states);
  p.dte = static_cast<float*>(dte);
  p.dfs = static_cast<float*>(dfs);
  const int batch = static_cast<int>(dims[0]);
  p.nc = static_cast<int>(dims[1]);
  p.q = static_cast<int>(dims[2]);
  p.h = static_cast<int>(dims[3]);
  p.p = static_cast<int>(dims[4]);
  p.rep = p.h / static_cast<int>(dims[5]);
  p.n = static_cast<int>(dims[6]);
  for (int t = 0; t < 5; ++t) {
    p.sx[t] = dims[7 + t];
    if (t < 4) p.sla[t] = dims[12 + t];
    p.sb[t] = dims[16 + t];
    p.sc[t] = dims[21 + t];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(p, batch, st);
  if (dtype == kBF16) return launch<__nv_bfloat16>(p, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
