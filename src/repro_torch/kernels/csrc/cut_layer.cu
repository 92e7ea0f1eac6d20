// Cut-layer int8 link codec for Hopper (sm_90a): three kernels behind a
// plain C interface, loaded with ctypes by repro_torch/kernels/build.py.
//
//   K1 cut_quantize   replaces src/repro/kernels/act_compress/act_compress.py
//                     quantize_pallas (_quant_kernel)
//   K2 cut_dequantize replaces src/repro/kernels/act_compress/act_compress.py
//                     dequantize_pallas (_dequant_kernel)
//   K3 cut_roundtrip  replaces src/repro/kernels/cut_fuse/cut_fuse.py
//                     roundtrip_pallas (_roundtrip_kernel)
//
// What they compute, per row of a (T, D) tensor (one row is one (b, h, w)
// position of an NHWC activation, D its channels):
//   scale = max(max|x|, 1e-12) * f32(1/127)
//   q     = clip(rint(x / scale), -127, 127)          as int8
//   out   = f32(q) * scale                            cast to the out dtype
// The reference is compiled by XLA, which rewrites the division by the
// constant 127 into a multiply by its f32 reciprocal (0x1.020408p-7); the
// division by the per-row scale stays a true division.  These kernels do
// exactly that (__fmul_rn, __fdiv_rn, rintf = round half to even,
// __fmul_rn, __float2bfloat16_rn) and are built without --use_fast_math, so
// q, scale and the roundtrip are bit-equal to the reference and to the
// plain PyTorch versions beside the wrappers.  Inputs are assumed finite.
//
// Bound on this card: bytes.  Per element K1 reads 4 (f32) and writes 1,
// K2 reads 1 and writes 4, K3 reads 4 and writes 4, against a handful of
// flops; at the main path's shape (T = 80 * 56 * 56 = 250,880, D = 160)
// K3 moves 321 MB per step, about 96 us at 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block.  Lanes stride
// over the row, so every warp load touches consecutive addresses; the row
// max is a warp-shuffle reduction; the second pass reads the row again,
// which the block's few KB keep in L1, so device memory sees each input
// byte once.  D need not be a power of two or a multiple of 32: lanes past
// the row edge simply do no work.  K3 never writes the int8.  Making the
// loads 16 bytes wide is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr float kInv127 = 0x1.020408p-7f;  // f32(1 / 127), as XLA folds it
constexpr float kMinAmax = 1e-12f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float row_scale(const T* x, int d, int lane) {
  float amax = 0.f;
  for (int j = lane; j < d; j += kWarp) amax = fmaxf(amax, fabsf(load_f(x + j)));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
}

// The int8 level of x as a float holding an integer in [-127, 127].
__device__ __forceinline__ float quant_level(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

__device__ __forceinline__ long long warp_row() {
  return (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scale, long long rows, int d) {
  const long long row = warp_row();
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % kWarp;
  const T* xr = x + row * d;
  const float s = row_scale(xr, d, lane);
  int8_t* qr = q + row * d;
  for (int j = lane; j < d; j += kWarp)
    qr[j] = static_cast<int8_t>(__float2int_rn(quant_level(load_f(xr + j), s)));
  if (lane == 0) scale[row] = s;
}

template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, long long rows, int d) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const float s = scale[row];
  const int8_t* qr = q + row * d;
  T* orow = out + row * d;
  for (int j = lane; j < d; j += kWarp)
    store_f(orow + j, __fmul_rn(static_cast<float>(qr[j]), s));
}

template <typename T>
__global__ void roundtrip_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 long long rows, int d) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const T* xr = x + row * d;
  const float s = row_scale(xr, d, lane);
  T* orow = out + row * d;
  for (int j = lane; j < d; j += kWarp)
    store_f(orow + j, __fmul_rn(quant_level(load_f(xr + j), s), s));
}

dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

constexpr int kThreads = kWarp * kRowsPerBlock;

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted, a cudaError_t otherwise (an unknown dtype
// code returns cudaErrorInvalidValue without launching).
extern "C" {

int cut_quantize(const void* x, void* q, void* scale, long long rows, int d,
                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    quantize_kernel<float><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, d);
  else if (dtype == kBF16)
    quantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int cut_dequantize(const void* q, const void* scale, void* out, long long rows,
                   int d, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32)
    dequantize_kernel<float><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, d);
  else if (out_dtype == kBF16)
    dequantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int cut_roundtrip(const void* x, void* out, long long rows, int d, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    roundtrip_kernel<float><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, d);
  else if (dtype == kBF16)
    roundtrip_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        rows, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
