// Causal GQA flash attention, forward only, for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes by repro_torch/kernels/build.py.
//
//   K7 flash_attention_fwd  replaces src/repro/kernels/flash_attention/
//                           flash_attention.py flash_attention_pallas
//                           (_kernel)
//
// What it computes, for every batch b, query head h and query row i (head h
// reads kv head h / rep, rep = H / KV; S_q == S_k == S):
//   s_ij = (q_i . k_j) * scale,  scale = 1 / sqrt(D)
//   s_ij = -1e30 where j > i (causal)
//   o_i  = sum_j softmax_j(s_i) v_j
// with the online softmax of the reference: a running max m (from -1e30),
// sum l and accumulator acc in f32, per key tile
//   m' = max(m, max_j s_ij);  p_j = exp(s_ij - m');  c = exp(m - m')
//   l  = l c + sum_j p_j;     acc = acc c + sum_j p_j v_j
// and o_i = acc / max(l, 1e-30), cast to q's dtype.  Key tiles that lie
// wholly after the query tile are not visited: only keys up to the
// diagonal are computed.  Inputs are f32 or bf16, all of one type; the
// arithmetic is f32 (expf and a true division; built without fast math),
// so the kernel differs from the plain version only in summation order.
//
// Layout: q, k, v and o are read and written by stride, with the last
// (head_dim) axis contiguous, so the model's (B, S, H, D) tensors need no
// transpose (ops.flash_attention passes their (B, H, S, D) views).
//
// Bound on this card: at the scoring shape (B 4, H 9, KV 3, S 2048, D 64,
// bf16, causal) the pairs j <= i need 1.93e10 flops (two products of
// 2 S(S+1)/2 D each per head): 0.0195 ms at 989 TFLOP/s bf16; the bytes
// (q, k, v read once, o written once) are 25.2 MB, 0.0075 ms.  So the bound
// is operations, and only tensor cores reach it.
//
// Design, simple and right first.  One block per (query tile of 128 rows,
// head, batch); heaviest (last) query tiles are launched first.  Each query
// row is owned by D / 32 adjacent threads, each holding 32 of its q values
// and 32 of its accumulator in registers (float4 chunks interleaved, so the
// threads of a row read neighbouring shared-memory words).  k and v tiles of
// 32 keys are staged in shared memory as f32; per key the row's threads
// take their partial dot products and add them with warp shuffles, so every
// thread of the row holds the same scores, max, sum and probabilities.
// CUDA-core f32 FMAs: the 67 TFLOP/s f32 rate, not the tensor cores, caps
// this version; mma.sync / wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block (the reference's block_q)
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kChunks = 8;    // float4 chunks of q / acc per thread (32 dims)
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {  // element strides of a (B, H, S, D) view; D is contiguous
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int rep;    // H / KV
  int seq;    // S
  float scale;
  int causal;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
flash_fwd_kernel(Params P) {
  constexpr int kTpr = D / 32;  // threads per query row
  constexpr int kC4 = D / 4;    // float4 chunks per row
  __shared__ float4 ks[kBlockK * kC4];
  __shared__ float4 vs[kBlockK * kC4];

  const int nq = (P.seq + kBlockQ - 1) / kBlockQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / P.rep;
  const int tid = threadIdx.x;
  const int row = qt * kBlockQ + tid / kTpr, sub = tid % kTpr;
  const bool live = row < P.seq;

  const T* q = static_cast<const T*>(P.q) + b * P.sq.b + h * P.sq.h;
  const T* k = static_cast<const T*>(P.k) + b * P.sk.b + hk * P.sk.h;
  const T* v = static_cast<const T*>(P.v) + b * P.sv.b + hk * P.sv.h;

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kTpr * i;
    qr[i] = live ? load4(q + row * P.sq.s + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  const int kend = P.causal ? min(P.seq, (qt + 1) * kBlockQ) : P.seq;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kBlockK * kC4; e += blockDim.x) {
      const int key = k0 + e / kC4, c = e % kC4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < P.seq) {
        kk = load4(k + key * P.sk.s + 4 * c);
        vv = load4(v + key * P.sv.s + 4 * c);
      }
      ks[e] = kk;
      vs[e] = vv;
    }
    __syncthreads();

    float sc[kBlockK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = ks[j * kC4 + sub + kTpr * i];
        dot = fmaf(qr[i].x, kk.x, dot);
        dot = fmaf(qr[i].y, kk.y, dot);
        dot = fmaf(qr[i].z, kk.z, dot);
        dot = fmaf(qr[i].w, kk.w, dot);
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + j;
      const bool visible = key < P.seq && (!P.causal || key <= row);
      sc[j] = visible ? dot * P.scale : kNegInf;
      mt = fmaxf(mt, sc[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vs[j * kC4 + sub + kTpr * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* o = static_cast<T*>(P.o) + b * P.so.b + h * P.so.h + row * P.so.s;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kTpr * i;
    store4(o + 4 * c, make_float4(acc[i].x / den, acc[i].y / den,
                                  acc[i].z / den, acc[i].w / den));
  }
}

template <typename T, int D>
void launch(const Params& p, int batch, int heads, cudaStream_t st) {
  const dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kBlockQ * (D / 32), 0, st>>>(p);
}

template <typename T>
int dispatch_d(const Params& p, int batch, int heads, int d, cudaStream_t st) {
  switch (d) {
    case 32: launch<T, 32>(p, batch, heads, st); break;
    case 64: launch<T, 64>(p, batch, heads, st); break;
    case 128: launch<T, 128>(p, batch, heads, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: B, H, KV, S, D, then the (b, h, s) element strides of q, k, v and o
// (17 values, host memory).  Launches on `stream` and returns
// cudaGetLastError(); an unknown dtype code or head_dim returns
// cudaErrorInvalidValue without launching.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const long long* dims, float scale, int causal,
                        int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* s[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int t = 0; t < 4; ++t) *s[t] = Strides{dims[5 + 3 * t], dims[6 + 3 * t], dims[7 + 3 * t]};
  const int batch = static_cast<int>(dims[0]), heads = static_cast<int>(dims[1]);
  p.rep = heads / static_cast<int>(dims[2]);
  p.seq = static_cast<int>(dims[3]);
  p.scale = scale;
  p.causal = causal;
  const int d = static_cast<int>(dims[4]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(p, batch, heads, d, st);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(p, batch, heads, d, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
