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
// diagonal are computed.  Inputs are f32 or bf16, all of one type; one
// kernel for each (flash_fwd_f32_kernel, flash_fwd_bf16_kernel).
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
// f32 (flash_fwd_f32_kernel): true f32 products on CUDA-core FMAs, expf
// and a true division (built without fast math), so it differs from the
// plain version only in summation order (2e-6 at the reference's test
// shapes, 1e-5 at the scoring shape; TF32 or bf16 tensor cores would not
// meet those bars).  One block per (query tile of 128 rows, head, batch);
// each query row is owned by D / 32 adjacent threads, each holding 32 of its
// q values and 32 of its accumulator in registers; k and v tiles of 32 keys
// are staged in shared memory as f32, and the row's partial dot products
// are joined with warp shuffles.  The 67 TFLOP/s f32 rate caps it.
//
// bf16 (flash_fwd_bf16_kernel), the model's path: both products on the
// tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32, in the FA2 register
// layout.  One block of 4 warps per (query tile, head, batch), heaviest
// (last) query tiles launched first; each warp owns 32 query rows at
// head_dim 64 (two 16-row mma tiles, so every k and v fragment read from
// shared memory feeds two products), 16 at 32 and 128 (m_tiles), and keeps
// their q fragments in registers: 128- or 64-row query tiles.  K and V tiles of 64 keys go to
// shared memory by 16-byte cp.async in a ring of two stages, so tile t+1
// loads while tile t is computed; each tile row is padded by 16 bytes, so
// the 8 rows an ldmatrix reads fall in distinct banks.  S = Q K^T reads K
// with ldmatrix, O += P V reads V with ldmatrix.trans.  The online softmax
// (m, l, the rescale of acc) runs in f32 registers in the accumulator
// layout: a row's 64 scores lie in the 4 threads of a quad, joined by two
// shuffles; each exponential is one FFMA (scores times scale * log2(e),
// less the row max in those units) and one ex2.approx.  P is packed to bf16 straight from the S accumulator
// into the A operand of P V and never touches shared memory.  The causal
// mask (and the S bound of a ragged last tile) is applied only on the
// tiles that need it, decided per warp; a warp skips a causal tile that
// lies past all of its rows.
// Numerics: rounding P to bf16 before P V departs from the reference, which
// keeps p in f32: about 2^-9 relative error per weight (l is summed from
// the f32 p), before the output's own bf16 rounding.  It is held to the
// reference's bf16 bar, 2e-2, like the output rounding alone.
// Next: wgmma with TMA (a warpgroup per 64 query rows, K/V by TMA into an
// mbarrier-guarded ring) is what reaches the full tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 128;  // query rows per block (the reference's block_q)
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kChunks = 8;    // float4 chunks of q / acc per thread (32 dims)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
flash_fwd_f32_kernel(Params P) {
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

  const float* q = static_cast<const float*>(P.q) + b * P.sq.b + h * P.sq.h;
  const float* k = static_cast<const float*>(P.k) + b * P.sk.b + hk * P.sk.h;
  const float* v = static_cast<const float*>(P.v) + b * P.sv.b + hk * P.sv.h;

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
  float* o = static_cast<float*>(P.o) + b * P.so.b + h * P.so.h + row * P.so.s;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kTpr * i;
    *reinterpret_cast<float4*>(o + 4 * c) =
        make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den, acc[i].w / den);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBN = 64;           // keys per tile
constexpr int kPad = 8;           // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// 16-row mma tiles per warp: two at head_dim 64, so each k / v fragment
// read from shared memory feeds two products (half the ldmatrix reads per
// product; faster on the H100); one at 128, where two do not fit in the
// registers, and at 32, where one measured faster
template <int D>
__host__ __device__ constexpr int m_tiles() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int block_rows() { return 16 * m_tiles<D>() * kWarps; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, negligible beside the row max's weight of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS rows of D bf16 from `src` (row stride `stride` elements), starting
// at row `row0`, into shared memory at `dst` (row stride D + kPad); rows at
// or past `seq` are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int seq,
                                          int tid) {
  constexpr int kCpr = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kCpr % (kWarps * 32) == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kCpr / (kWarps * 32); ++i) {
    const int e = tid + i * kWarps * 32;
    const int r = e / kCpr, c = e % kCpr, row = row0 + r;
    const bool ok = row < seq;
    cp_async16(dst + 2 * (r * (D + kPad) + 8 * c),
               src + (ok ? row : 0) * stride + 8 * c, ok);
  }
}

template <int D>
__host__ __device__ constexpr int bf16_smem_bytes() {  // q tile + two stages of k and v tiles
  return 2 * (block_rows<D>() + 4 * kBN) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(Params P) {
  constexpr int kMT = m_tiles<D>();     // 16-row tiles per warp
  constexpr int kBM = block_rows<D>();  // query rows per block
  constexpr int kRS = D + kPad;         // shared-memory row stride (elements)
  constexpr int kTile = kBN * kRS;      // elements of one k or v tile
  constexpr int kDC = D / 16;           // 16-wide chunks of head_dim
  constexpr int kNB = kBN / 8;          // 8-key blocks of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kBM * kRS;  // 2 stages
  __nv_bfloat16* sv = sk + 2 * kTile;  // 2 stages

  const int nq = (P.seq + kBM - 1) / kBM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / P.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // the mma fragment coordinates
  const int q0 = qt * kBM;
  const int wrow = q0 + 16 * kMT * warp;  // the warp's first query row

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(P.q) + b * P.sq.b + h * P.sq.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(P.k) + b * P.sk.b + hk * P.sk.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(P.v) + b * P.sv.b + hk * P.sv.h;

  const int kend = P.causal ? min(P.seq, q0 + kBM) : P.seq;
  const int ntiles = (kend + kBN - 1) / kBN;

  load_rows<kBM, D>(smem_u32(sq), q, P.sq.s, q0, P.seq, tid);
  load_rows<kBN, D>(smem_u32(sk), k, P.sk.s, 0, P.seq, tid);
  load_rows<kBN, D>(smem_u32(sv), v, P.sv.s, 0, P.seq, tid);
  cp_async_commit();

  uint32_t qf[kMT][kDC][4];  // the warp's q rows as A fragments
  float acc[kMT][D / 8][4];  // O in the accumulator layout
  float m[kMT][2], l[kMT][2];  // rows g and g + 8 of each tile: running
                               // max, and this thread's part of the sum
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float sl2 = P.scale * kLog2e;  // exp(x scale) = 2^(x sl2)

  // ldmatrix lane offsets: A (q) and B-from-rows (k) and B-trans (v)
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int k_row = (lane % 8) + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
  const int v_row = a_row, v_col = a_col;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {  // the next tile into the other stage
      load_rows<kBN, D>(smem_u32(sk + (st ^ 1) * kTile), k, P.sk.s, (t + 1) * kBN, P.seq, tid);
      load_rows<kBN, D>(smem_u32(sv + (st ^ 1) * kTile), v, P.sv.s, (t + 1) * kBN, P.seq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int c = 0; c < kDC; ++c)
          ldsm_x4(smem_u32(sq + (16 * (kMT * warp + mt) + a_row) * kRS + 16 * c + a_col), qf[mt][c]);
    }

    const int key0 = t * kBN;
    // a causal tile past all of this warp's rows adds nothing to them
    if (P.causal && key0 >= wrow + 16 * kMT) {
      __syncthreads();
      continue;
    }

    // S = Q K^T (16 x 64 per tile)
    float s[kMT][kNB][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNB; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    const __nv_bfloat16* kt = sk + st * kTile;
#pragma unroll
    for (int p = 0; p < kNB / 2; ++p) {
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        uint32_t r[4];
        ldsm_x4(smem_u32(kt + (16 * p + k_row) * kRS + 16 * c + k_col), r);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * p], qf[mt][c], r[0], r[1]);
          mma_bf16(s[mt][2 * p + 1], qf[mt][c], r[2], r[3]);
        }
      }
    }

    // mask past the diagonal and past S
    if (key0 + kBN > P.seq || (P.causal && key0 + kBN - 1 > wrow)) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNB; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = key0 + 8 * j + 2 * tig + (i & 1);
            const int row = wrow + 16 * mt + g + 8 * (i >> 1);
            if (key >= P.seq || (P.causal && key > row)) s[mt][j][i] = kNegInf;
          }
    }

    // online softmax, rows g (i = 0, 1) and g + 8 (i = 2, 3) of each tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kNB; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        const float corr = ex2((m[mt][r] - m_new) * sl2);
        const float off = -m_new * sl2;  // p = 2^(s sl2 - m sl2), one FFMA
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const float p0 = ex2(fmaf(s[mt][j][2 * r], sl2, off));
          const float p1 = ex2(fmaf(s[mt][j][2 * r + 1], sl2, off));
          s[mt][j][2 * r] = p0;
          s[mt][j][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l[mt][r] = l[mt][r] * corr + sum;
        m[mt][r] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[mt][j][2 * r] *= corr;
          acc[mt][j][2 * r + 1] *= corr;
        }
      }
    }

    // O += P V: P (bf16) from the S fragments, V by ldmatrix.trans
    const __nv_bfloat16* vt = sv + st * kTile;
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * c][0], s[mt][2 * c][1]);
        a[mt][1] = pack_bf16(s[mt][2 * c][2], s[mt][2 * c][3]);
        a[mt][2] = pack_bf16(s[mt][2 * c + 1][0], s[mt][2 * c + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * c + 1][2], s[mt][2 * c + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kDC; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(smem_u32(vt + (16 * c + v_row) * kRS + 16 * dp + v_col), r);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for tile t + 2
  }

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(P.o) + b * P.so.b + h * P.so.h;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = fmaxf(sum, 1e-30f);
      const int row = wrow + 16 * mt + g + 8 * r;
      if (row >= P.seq) continue;
      __nv_bfloat16* orow = o + row * P.so.s + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[mt][j][2 * r] / den, acc[mt][j][2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const Params& p, int batch, int heads, cudaStream_t st) {
  const dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_f32_kernel<D><<<grid, kBlockQ * (D / 32), 0, st>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int batch, int heads, cudaStream_t st) {
  constexpr int bytes = bf16_smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above 48 KB only after this, on each device
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.seq + block_rows<D>() - 1) / block_rows<D>(), heads, batch);
  flash_fwd_bf16_kernel<D><<<grid, kWarps * 32, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch(const Params& p, int batch, int heads, int dtype, cudaStream_t st) {
  if (dtype == kF32) return launch_f32<D>(p, batch, heads, st);
  if (dtype == kBF16) return launch_bf16<D>(p, batch, heads, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dims: B, H, KV, S, D, then the (b, h, s) element strides of q, k, v and o
// (17 values, host memory).  Launches on `stream` and returns
// cudaGetLastError(); an unknown dtype code or head_dim returns
// cudaErrorInvalidValue without launching.  bf16 tensors need every
// non-last stride a multiple of 8 and 16-byte aligned starts (cp.async).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (static_cast<int>(dims[4])) {
    case 32: return launch<32>(p, batch, heads, dtype, st);
    case 64: return launch<64>(p, batch, heads, dtype, st);
    case 128: return launch<128>(p, batch, heads, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
