// Cut-layer int8 link codec for Hopper (sm_90a): four kernels behind a
// plain C interface, loaded with ctypes by repro_torch/kernels/build.py.
//
//   K1 cut_quantize   replaces src/repro/kernels/act_compress/act_compress.py
//                     quantize_pallas (_quant_kernel)
//   K2 cut_dequantize replaces src/repro/kernels/act_compress/act_compress.py
//                     dequantize_pallas (_dequant_kernel)
//   K3 cut_roundtrip  replaces src/repro/kernels/cut_fuse/cut_fuse.py
//                     roundtrip_pallas (_roundtrip_kernel)
//   K4 cut_noise_roundtrip
//                     replaces src/repro/kernels/cut_fuse/cut_fuse.py
//                     noise_roundtrip_pallas (_noise_kernel)
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
// K4 adds the cut-layer noise in the same pass:
//   out = T(roundtrip) + T(z * w_row)        an f32 add rounded to T
// with z the pre-scaled f32 noise and w the row's weight.  Each product is
// rounded on its own (__fmul_rn, then to T) and the sum is __fadd_rn, so
// nvcc's default -fmad=true cannot contract a product into an FMA: that is
// the reference's pin_product order, and in bf16 XLA's f32 add rounded
// once to bf16.  K4 equals K3 followed by the separate masked add, bit for
// bit, in f32 and bf16.
//
// Bound on this card: bytes.  Per element K1 reads 4 (f32) and writes 1,
// K2 reads 1 and writes 4, K3 reads 4 and writes 4, against a handful of
// flops; at the main path's shape (T = 80 * 56 * 56 = 250,880, D = 160)
// K3 moves 321 MB per step, about 96 us at 3.35 TB/s.  K4 reads x and z and
// writes the output, 12 B per f32 element (483 MB, 0.144 ms at that shape).
//
// Bound, and what the design does about it.  K1 moves 5 B an element in
// f32 and 3 in bf16 for one true division and a few other f32 operations,
// so the bytes bound it, but only if enough of them are in flight: at the
// main path's D = 160 one warp a row with lanes striding by 32 elements
// moved 64 B a load in bf16, read the row twice and did five elements a
// lane, and K1 in bf16 took 95% of its f32 time on 60% of the bytes.
// K1 therefore has its own kernels:
//   vector path (quantize_vec_kernel): a group of G lanes takes a row, G a
//     power of two from 1 to 32 (32 / G rows a warp) that the wrapper
//     chooses from D and the dtype (act_compress.quantize_plan).  Each
//     lane issues all its 16-byte loads of the row (4 f32 or 8 bf16, the
//     group's lanes on neighbouring vectors) before it uses any, keeps
//     them in registers for both the absmax, a G-wide shuffle reduction,
//     and the quantize, so x is read once, and stores each vector's levels
//     packed (4 or 8 bytes).  The group's first lane writes the scale.
//     A block of 256 threads takes 256 / G rows, and at most 2^16 blocks
//     walk over the rows with a grid stride.  It needs D a multiple of the
//     vector, x 16-byte and q vector-aligned, and rows of at most 32 x 8
//     vectors (D <= 1024 f32, 2048 bf16);
//   general path (quantize_general_kernel): any D and alignment, one warp
//     a row as K2-K4 (below), reading the row twice.
// The wrapper chooses the path from the shape and the pointers; the entry
// point refuses a plan the vector path cannot take.  Row offsets are 64-bit.
//
// K2-K4: one warp per row, eight rows per 256-thread block.  Lanes stride
// over the row, so every warp load touches consecutive addresses; the row
// max is a warp-shuffle reduction; the second pass reads the row again,
// which the block's few KB keep in L1, so device memory sees each input
// byte once.  D need not be a power of two or a multiple of 32: lanes past
// the row edge simply do no work.  K3 never writes the int8.  They do not
// take K1's 16-byte groups yet.

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

// ---- K1 ----------------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kMaxVecs = 8;           // act_compress.MAX_VECS
constexpr long long kMaxQuantBlocks = 1 << 16;

// The values of 16 bytes of T as floats (exact), in memory order.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // the lower address
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Four int8 levels (the low bytes of a..d) packed in memory order.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ int level(float x, float scale) {
  return __float2int_rn(quant_level(x, scale));
}

// The levels of one vector's values f into q at vector j of the row qr.
__device__ __forceinline__ void store_levels(int8_t* qr, int j, const float* f,
                                             float s, const float*) {
  reinterpret_cast<uint32_t*>(qr)[j] =
      pack4(level(f[0], s), level(f[1], s), level(f[2], s), level(f[3], s));
}
__device__ __forceinline__ void store_levels(int8_t* qr, int j, const float* f,
                                             float s, const __nv_bfloat16*) {
  reinterpret_cast<uint2*>(qr)[j] = make_uint2(
      pack4(level(f[0], s), level(f[1], s), level(f[2], s), level(f[3], s)),
      pack4(level(f[4], s), level(f[5], s), level(f[6], s), level(f[7], s)));
}

// The vector path: a group of 2^glog lanes a row, each lane holding up to
// V 16-byte vectors of it (vector j of the row in lane j % G, slot j / G).
template <typename T, int V>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, long long rows, int d,
                        int glog) {
  using Vec = Vec16<T>;
  const int lane = threadIdx.x % kWarp;
  const int gl = lane & ((1 << glog) - 1);  // the lane within its group
  const int nvec = d / Vec::kN;
  const long long rows_per_warp = kWarp >> glog;
  const long long warps = (long long)gridDim.x * (kQuantThreads / kWarp);
  // every lane of a warp runs the same iterations (the shuffles need all)
  for (long long w = (long long)blockIdx.x * (kQuantThreads / kWarp) +
                     threadIdx.x / kWarp;
       w * rows_per_warp < rows; w += warps) {
    const long long row = w * rows_per_warp + (lane >> glog);
    const bool live = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);
    uint4 v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {  // all loads before the first use
      const int j = gl + (k << glog);
      v[k] = (live && j < nvec) ? __ldg(xr + j) : make_uint4(0, 0, 0, 0);
    }
    float amax = 0.f;  // a zero vector leaves it as it is
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float f[Vec::kN];
      Vec::unpack(v[k], f);
#pragma unroll
      for (int e = 0; e < Vec::kN; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
    for (int off = (1 << glog) >> 1; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
    if (!live) continue;
    int8_t* qr = q + row * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = gl + (k << glog);
      if (j < nvec) {
        float f[Vec::kN];
        Vec::unpack(v[k], f);
        store_levels(qr, j, f, s, x);
      }
    }
    if (gl == 0) scale[row] = s;
  }
}

// The general path: one warp a row, any D and alignment, the row read twice.
template <typename T>
__global__ void quantize_general_kernel(const T* __restrict__ x,
                                        int8_t* __restrict__ q,
                                        float* __restrict__ scale,
                                        long long rows, int d) {
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

// v rounded to T's precision and back to float (the identity for f32).
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void noise_roundtrip_kernel(const T* __restrict__ x,
                                       const float* __restrict__ z,
                                       const float* __restrict__ w,
                                       T* __restrict__ out, long long rows,
                                       int d) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const T* xr = x + row * d;
  const float s = row_scale(xr, d, lane);
  const float wr = w[row];
  const float* zr = z + row * d;
  T* orow = out + row * d;
  for (int j = lane; j < d; j += kWarp) {
    const float r = round_as(__fmul_rn(quant_level(load_f(xr + j), s), s), xr);
    const float zw = round_as(__fmul_rn(zr[j], wr), xr);
    store_f(orow + j, __fadd_rn(r, zw));
  }
}

dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

constexpr int kThreads = kWarp * kRowsPerBlock;

template <typename T, int V>
void launch_vec(const void* x, void* q, void* scale, long long rows, int d,
                int glog, cudaStream_t st) {
  const long long rows_per_block = (long long)kQuantThreads >> glog;
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxQuantBlocks) blocks = kMaxQuantBlocks;
  quantize_vec_kernel<T, V><<<static_cast<unsigned>(blocks), kQuantThreads,
                              0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), rows, d, glog);
}

template <typename T>
int quantize_as(const void* x, void* q, void* scale, long long rows, int d,
                int group, int vecs, cudaStream_t st) {
  if (vecs == 0) {  // the general path
    quantize_general_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, d);
    return cudaGetLastError();
  }
  constexpr int kN = Vec16<T>::kN;
  int glog = 0;
  while ((1 << glog) < group) ++glog;
  if ((1 << glog) != group || group > kWarp || vecs < 0 || vecs > kMaxVecs ||
      d % kN || d / kN > group * vecs ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % kN)
    return cudaErrorInvalidValue;  // a plan the vector path cannot take
  switch (vecs) {
    case 1: launch_vec<T, 1>(x, q, scale, rows, d, glog, st); break;
    case 2: launch_vec<T, 2>(x, q, scale, rows, d, glog, st); break;
    case 3: launch_vec<T, 3>(x, q, scale, rows, d, glog, st); break;
    case 4: launch_vec<T, 4>(x, q, scale, rows, d, glog, st); break;
    case 5: launch_vec<T, 5>(x, q, scale, rows, d, glog, st); break;
    case 6: launch_vec<T, 6>(x, q, scale, rows, d, glog, st); break;
    case 7: launch_vec<T, 7>(x, q, scale, rows, d, glog, st); break;
    default: launch_vec<T, 8>(x, q, scale, rows, d, glog, st); break;
  }
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted, a cudaError_t otherwise (an unknown dtype
// code returns cudaErrorInvalidValue without launching).
extern "C" {

// K1.  group, vecs: the vector path's plan (act_compress.quantize_plan), or
// vecs = 0 for the general path.
int cut_quantize(const void* x, void* q, void* scale, long long rows, int d,
                 int dtype, int group, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return quantize_as<float>(x, q, scale, rows, d, group, vecs, st);
  if (dtype == kBF16)
    return quantize_as<__nv_bfloat16>(x, q, scale, rows, d, group, vecs, st);
  return cudaErrorInvalidValue;
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

int cut_noise_roundtrip(const void* x, const void* z, const void* w, void* out,
                        long long rows, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* wf = static_cast<const float*>(w);
  if (dtype == kF32)
    noise_roundtrip_kernel<float><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const float*>(x), zf, wf, static_cast<float*>(out), rows,
        d);
  else if (dtype == kBF16)
    noise_roundtrip_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), zf, wf,
        static_cast<__nv_bfloat16*>(out), rows, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
