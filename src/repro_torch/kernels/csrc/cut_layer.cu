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
// with z the pre-scaled f32 noise and w the row's weight (any value: ones
// today, the pad-and-mask weights of a padded batch too).  Each product is
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
// Bound, and what the design does about it.  The bytes bound these
// kernels only if enough of them are in flight and the per-row work stays
// small.  One warp a row with lanes striding by 32 elements moved 64 B a
// load in bf16, read the row twice and paid a 5-step shuffle a row: at
// D = 64 that set the time (K1 at 27% of its bound in bf16, K3 at 36%,
// K2 at 46%).  So all four run on one walk over row groups:
//   vector path: a group of G lanes takes a row, G a power of two from 1
//     to 32 (32 / G rows a warp) that the wrapper chooses from D, the
//     dtype and the pointers (act_compress.vector_plan).  A vector is 16
//     bytes of the float side (4 f32 or 8 bf16 values) and its levels the
//     4 or 8 bytes of q at the same place; the group's lanes take
//     neighbouring vectors.  K1, K3 and K4 share one front half: each lane
//     issues all its 16-byte loads of the row before it uses any and keeps
//     them in registers (load_row), the absmax is a G-wide shuffle
//     reduction, the row is read once, and then
//       K1 stores each vector's levels packed (4 or 8 bytes) and the
//          group's first lane the scale;
//       K3 stores each vector's roundtrip as one 16-byte vector (the int8
//          never leaves registers);
//       K4 also loads the row's z (one float4 per f32 vector of x, two
//          per bf16 one) and w[row] before the shuffle, so the whole row
//          is in flight at once, and stores 16-byte vectors as K3.
//     K2 reverses K1's store: each lane issues the loads of all its
//     vectors' levels (one 4- or 8-byte load each) and of its row's scale
//     (the group's lanes read the same 4 bytes, one transaction) before
//     the first multiply, and stores each vector as one 16-byte vector;
//     it needs no shuffle.  Its levels are narrow loads, which wide
//     groups serve best, so its plan (act_compress.dequantize_plan) takes
//     about 2 vectors a lane where K1's takes about 4.
//     A block of 256 threads takes 256 / G rows, and at most 2^16 blocks
//     walk over the rows with a grid stride: the grid comes from the plan
//     alone, so a launch can be captured in a CUDA graph (the plan depends
//     on the pointers, which stay the same at every replay of the graph's
//     pool).  It needs D a multiple of the vector, x, out and z on 16-byte
//     boundaries, q on a vector's levels, and rows of at most 32 x 8
//     vectors (D <= 1024 f32, 2048 bf16);
//   general path: any D and alignment, one warp a row, lanes striding
//     over it (K1, K3 and K4 read the row twice: the second pass finds it
//     in L1).
// The wrapper chooses the path from the shape and the pointers; the entry
// point refuses a plan the vector path cannot take.  Row offsets are
// 64-bit on both paths, for x, z, q and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// v rounded to T's precision and back to float (the identity for f32).
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The int8 level of x as a float holding an integer in [-127, 127].
__device__ __forceinline__ float quant_level(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

// ---- the vector path (K1-K4) -------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kMaxVecs = 8;           // act_compress.MAX_VECS
constexpr long long kMaxVecBlocks = 1 << 16;

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The values of 16 bytes of T as floats (exact), in memory order, and
// back (rounded to T).
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
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
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
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A lane's place in the vector path's walk: a group of 2^glog lanes takes
// a row, a warp 32 / G rows at a time, and the grid's warps stride over the
// rows.  Every lane of a warp runs the same iterations (the shuffles need
// all of them); a lane whose row lies past the last is not live.  Vector j
// of a row is in lane j % G of its group, slot j / G.
struct RowGroups {
  long long rows, first, step;  // first: the warp's first row
  int glog, gl, sub;            // sub: the lane's group in its warp

  __device__ __forceinline__ RowGroups(long long rows_, int glog_)
      : rows(rows_), glog(glog_) {
    const int lane = threadIdx.x % kWarp;
    gl = lane & ((1 << glog) - 1);
    sub = lane >> glog;
    first = ((long long)blockIdx.x * (kVecThreads / kWarp) +
             threadIdx.x / kWarp) << (5 - glog);
    step = ((long long)gridDim.x * (kVecThreads / kWarp)) << (5 - glog);
  }
  __device__ __forceinline__ bool more() const { return first < rows; }
  __device__ __forceinline__ void next() { first += step; }
  __device__ __forceinline__ bool live() const { return first + sub < rows; }
  // the lane's row (row 0 for a lane that is not live: a safe address)
  __device__ __forceinline__ long long row() const {
    return live() ? first + sub : 0;
  }
  __device__ __forceinline__ int vec(int k) const { return gl + (k << glog); }
};

// The front half of the vector path, shared by K1, K3 and K4: the lane
// issues all its 16-byte loads of its row (slots past the row, or of a
// lane that is not live, stay zero) before it uses any, then the row's
// absmax is a G-wide shuffle reduction; returns the row's scale.
template <typename T, int V>
__device__ __forceinline__ float load_row(const T* __restrict__ x, int d,
                                          const RowGroups& g, uint4 (&v)[V]) {
  using Vec = Vec16<T>;
  const int nvec = d / Vec::kN;
  const bool live = g.live();
  const uint4* xr = reinterpret_cast<const uint4*>(x + g.row() * d);
#pragma unroll
  for (int k = 0; k < V; ++k) {  // all loads before the first use
    const int j = g.vec(k);
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
  for (int off = (1 << g.glog) >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
}

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

// K1: the levels, packed, and the scale.
template <typename T, int V>
__global__ void __launch_bounds__(kVecThreads)
    quantize_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, long long rows, int d,
                        int glog) {
  using Vec = Vec16<T>;
  const int nvec = d / Vec::kN;
  for (RowGroups g(rows, glog); g.more(); g.next()) {
    uint4 v[V];
    const float s = load_row<T, V>(x, d, g, v);
    if (!g.live()) continue;
    int8_t* qr = q + g.row() * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g.vec(k);
      if (j < nvec) {
        float f[Vec::kN];
        Vec::unpack(v[k], f);
        store_levels(qr, j, f, s, x);
      }
    }
    if (g.gl == 0) scale[g.row()] = s;
  }
}

// The levels of one vector of T: 4 bytes of q for 4 f32 values, 8 for 8
// bf16 ones (what store_levels writes), and their values as floats
// (exact: each byte sign-extended, then converted).
template <typename T>
struct Levels;
template <>
struct Levels<float> {
  using type = uint32_t;
};
template <>
struct Levels<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ void unpack_levels(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}
__device__ __forceinline__ void unpack_levels(const uint2& w, float* f) {
  unpack_levels(w.x, f);
  unpack_levels(w.y, f + 4);
}

// K2: each vector's levels times the row's scale, stored as one 16-byte
// vector of T.  No reduction, so a lane whose row lies past the last
// simply skips it.
template <typename T, int V>
__global__ void __launch_bounds__(kVecThreads)
    dequantize_vec_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ scale,
                          T* __restrict__ out, long long rows, int d,
                          int glog) {
  using Vec = Vec16<T>;
  using L = typename Levels<T>::type;
  const int nvec = d / Vec::kN;
  for (RowGroups g(rows, glog); g.more(); g.next()) {
    if (!g.live()) continue;
    const long long row = g.row();
    const L* qr = reinterpret_cast<const L*>(q + row * d);
    L lv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {  // all loads before the first use
      const int j = g.vec(k);
      lv[k] = j < nvec ? __ldg(qr + j) : L{};
    }
    const float s = __ldg(scale + row);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g.vec(k);
      if (j < nvec) {
        float f[Vec::kN];
        unpack_levels(lv[k], f);
#pragma unroll
        for (int e = 0; e < Vec::kN; ++e) f[e] = __fmul_rn(f[e], s);
        orow[j] = Vec::pack(f);
      }
    }
  }
}

// K3: the roundtrip of each vector, stored as one 16-byte vector of T.
template <typename T, int V>
__global__ void __launch_bounds__(kVecThreads)
    roundtrip_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long rows, int d, int glog) {
  using Vec = Vec16<T>;
  const int nvec = d / Vec::kN;
  for (RowGroups g(rows, glog); g.more(); g.next()) {
    uint4 v[V];
    const float s = load_row<T, V>(x, d, g, v);
    if (!g.live()) continue;
    uint4* orow = reinterpret_cast<uint4*>(out + g.row() * d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g.vec(k);
      if (j < nvec) {
        float f[Vec::kN];
        Vec::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < Vec::kN; ++e)
          f[e] = __fmul_rn(quant_level(f[e], s), s);
        orow[j] = Vec::pack(f);
      }
    }
  }
}

// K4: K3's roundtrip plus the row-weighted noise.  z and w are not needed
// for the absmax, so their loads go out before x's and the shuffle: the
// lane has its whole share of the row in flight at once.
template <typename T, int V>
__global__ void __launch_bounds__(kVecThreads)
    noise_roundtrip_vec_kernel(const T* __restrict__ x,
                               const float* __restrict__ z,
                               const float* __restrict__ w,
                               T* __restrict__ out, long long rows, int d,
                               int glog) {
  using Vec = Vec16<T>;
  constexpr int kZ = Vec::kN / 4;  // float4s of z per vector of x
  const int nvec = d / Vec::kN;
  for (RowGroups g(rows, glog); g.more(); g.next()) {
    const bool live = g.live();
    const float4* zr = reinterpret_cast<const float4*>(z + g.row() * d);
    float4 zv[V * kZ];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g.vec(k);
#pragma unroll
      for (int i = 0; i < kZ; ++i)
        zv[k * kZ + i] = (live && j < nvec) ? __ldg(zr + j * kZ + i)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float wr = live ? __ldg(w + g.row()) : 0.f;
    uint4 v[V];
    const float s = load_row<T, V>(x, d, g, v);
    if (!live) continue;
    uint4* orow = reinterpret_cast<uint4*>(out + g.row() * d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = g.vec(k);
      if (j < nvec) {
        float f[Vec::kN];
        Vec::unpack(v[k], f);
#pragma unroll
        for (int i = 0; i < kZ; ++i) {
          const float4 zi = zv[k * kZ + i];
          const float zf[4] = {zi.x, zi.y, zi.z, zi.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * i + e;
            const float r = round_as(__fmul_rn(quant_level(f[c], s), s), x);
            f[c] = __fadd_rn(r, round_as(__fmul_rn(zf[e], wr), x));
          }
        }
        orow[j] = Vec::pack(f);
      }
    }
  }
}

// ---- the general path: one warp a row, any D and alignment --------------

template <typename T>
__device__ __forceinline__ float row_scale(const T* x, int d, int lane) {
  float amax = 0.f;
  for (int j = lane; j < d; j += kWarp) amax = fmaxf(amax, fabsf(load_f(x + j)));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
}

__device__ __forceinline__ long long warp_row() {
  return (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
}

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

// ---- launches -------------------------------------------------------------

constexpr int kThreads = kWarp * kRowsPerBlock;

dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

// The vector path's grid: 256 / G rows a block, at most 2^16 blocks.
dim3 vec_grid(long long rows, int glog) {
  const long long per_block = (long long)kVecThreads >> glog;
  const long long blocks = (rows + per_block - 1) / per_block;
  return dim3(static_cast<unsigned>(blocks < kMaxVecBlocks ? blocks
                                                           : kMaxVecBlocks));
}

// log2(group) if (group, vecs) is a vector plan for rows of d elements of
// T, else -1.
template <typename T>
int plan_glog(int d, int group, int vecs) {
  constexpr int kN = Vec16<T>::kN;
  int glog = 0;
  while ((1 << glog) < group) ++glog;
  if ((1 << glog) != group || group > kWarp || vecs < 1 || vecs > kMaxVecs ||
      d % kN || d / kN > group * vecs)
    return -1;
  return glog;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// f(std::integral_constant<int, vecs>) for vecs in [V, kMaxVecs].
template <int V = 1, typename F>
void with_vecs(int vecs, F&& f) {
  if constexpr (V < kMaxVecs) {
    if (vecs != V) return with_vecs<V + 1>(vecs, f);
  }
  f(std::integral_constant<int, V>{});
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
  const int glog = plan_glog<T>(d, group, vecs);
  if (glog < 0 || !aligned(x, 16) || !aligned(q, Vec16<T>::kN))
    return cudaErrorInvalidValue;  // a plan the vector path cannot take
  with_vecs(vecs, [&](auto v) {
    quantize_vec_kernel<T, decltype(v)::value>
        <<<vec_grid(rows, glog), kVecThreads, 0, st>>>(
            static_cast<const T*>(x), static_cast<int8_t*>(q),
            static_cast<float*>(scale), rows, d, glog);
  });
  return cudaGetLastError();
}

template <typename T>
int dequantize_as(const void* q, const void* scale, void* out, long long rows,
                  int d, int group, int vecs, cudaStream_t st) {
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (vecs == 0) {
    dequantize_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(qt, sf, ot,
                                                              rows, d);
    return cudaGetLastError();
  }
  const int glog = plan_glog<T>(d, group, vecs);
  if (glog < 0 || !aligned(q, Vec16<T>::kN) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  with_vecs(vecs, [&](auto v) {
    dequantize_vec_kernel<T, decltype(v)::value>
        <<<vec_grid(rows, glog), kVecThreads, 0, st>>>(qt, sf, ot, rows, d,
                                                        glog);
  });
  return cudaGetLastError();
}

template <typename T>
int roundtrip_as(const void* x, void* out, long long rows, int d, int group,
                 int vecs, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vecs == 0) {
    roundtrip_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(xt, ot, rows, d);
    return cudaGetLastError();
  }
  const int glog = plan_glog<T>(d, group, vecs);
  if (glog < 0 || !aligned(x, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  with_vecs(vecs, [&](auto v) {
    roundtrip_vec_kernel<T, decltype(v)::value>
        <<<vec_grid(rows, glog), kVecThreads, 0, st>>>(xt, ot, rows, d, glog);
  });
  return cudaGetLastError();
}

template <typename T>
int noise_roundtrip_as(const void* x, const void* z, const void* w, void* out,
                       long long rows, int d, int group, int vecs,
                       cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* zf = static_cast<const float*>(z);
  const float* wf = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  if (vecs == 0) {
    noise_roundtrip_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(
        xt, zf, wf, ot, rows, d);
    return cudaGetLastError();
  }
  const int glog = plan_glog<T>(d, group, vecs);
  if (glog < 0 || !aligned(x, 16) || !aligned(z, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  with_vecs(vecs, [&](auto v) {
    noise_roundtrip_vec_kernel<T, decltype(v)::value>
        <<<vec_grid(rows, glog), kVecThreads, 0, st>>>(xt, zf, wf, ot, rows,
                                                        d, glog);
  });
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted, a cudaError_t otherwise (an unknown dtype
// code, or a vector plan the rows or pointers cannot take, returns
// cudaErrorInvalidValue without launching).  group, vecs: the vector
// path's plan (act_compress.vector_plan; K2's dequantize_plan), or vecs = 0
// for the general path.
extern "C" {

// K1
int cut_quantize(const void* x, void* q, void* scale, long long rows, int d,
                 int dtype, int group, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return quantize_as<float>(x, q, scale, rows, d, group, vecs, st);
  if (dtype == kBF16)
    return quantize_as<__nv_bfloat16>(x, q, scale, rows, d, group, vecs, st);
  return cudaErrorInvalidValue;
}

// K2: out of dtype out_dtype
int cut_dequantize(const void* q, const void* scale, void* out, long long rows,
                   int d, int out_dtype, int group, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32)
    return dequantize_as<float>(q, scale, out, rows, d, group, vecs, st);
  if (out_dtype == kBF16)
    return dequantize_as<__nv_bfloat16>(q, scale, out, rows, d, group, vecs,
                                        st);
  return cudaErrorInvalidValue;
}

// K3
int cut_roundtrip(const void* x, void* out, long long rows, int d, int dtype,
                  int group, int vecs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return roundtrip_as<float>(x, out, rows, d, group, vecs, st);
  if (dtype == kBF16)
    return roundtrip_as<__nv_bfloat16>(x, out, rows, d, group, vecs, st);
  return cudaErrorInvalidValue;
}

// K4: z f32 (rows, d), w f32 (rows,)
int cut_noise_roundtrip(const void* x, const void* z, const void* w, void* out,
                        long long rows, int d, int dtype, int group, int vecs,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return noise_roundtrip_as<float>(x, z, w, out, rows, d, group, vecs, st);
  if (dtype == kBF16)
    return noise_roundtrip_as<__nv_bfloat16>(x, z, w, out, rows, d, group,
                                             vecs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
