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
// are read in their own type.  Outputs: y_intra (b, nc, q, h, p), states
// (b, nc, h, n, p), dte and dfs (b, nc, q, h), all f32 and contiguous.
// Inputs are read by the strides of every axis (B and C are column slices
// of the conv output in the model).  q, n and p are multiples of 4 up to
// 128; partial tensor-core tiles are zero-filled and masked.
//
// Bound on this card: at the scoring shape (b 4, nc 16, q 128, h 24, p 64,
// g 1, n 128, bf16 B/C) the function moves 157.5 MB (xbar, y_intra and the
// states 50.3 MB each; la, B, C, dte, dfs the rest): 0.047 ms at 3.35 TB/s.
// Its lower-triangular products need 3.24e9 flops on bf16 operands (C B^T)
// and 4.84e9 on f32 ones (with L and xbar): 0.0033 ms at 989 TFLOP/s plus
// 0.072 ms at 67 TFLOP/s.  So the bound is operations, and nearly all of it
// is the f32 products M xbar and (B o dte)^T xbar on the CUDA cores.
//
// Design.  One block of 8 warps per (h, c, b), heads fastest, so the 24
// blocks of a chunk that share B and C run together and find them in L2.
//   1. Occupancy: B and C are staged in their own type (bf16 at the scoring
//      shape: 2 x 34 KB with padding), xbar in f32 (32 KB), and M is never
//      held whole: its lower triangle, packed in 8-row panels, takes C's
//      place once C B^T is in registers.  101 KB a block, so two blocks
//      (16 warps) share an SM.  (f32 B/C take 169 KB: one block.)
//   2. Staging into row-major tiles (a bf16 row padded by 16 bytes, so the
//      8 rows an ldmatrix reads fall in distinct banks), in 16-byte pieces:
//      by cp.async along rows whose last axis is contiguous, so xbar lands
//      while C B^T is computed; or by loads down columns whose q axis is
//      contiguous, 4 in flight a thread, scattered to the tile's rows.  The
//      model hands over the second layout (its conv puts the sequence
//      innermost: xbar, B and C are strided by 8192 along n and p), where
//      per-element loads took 0.51 ms a launch.  Other layouts take a
//      scalar path that walks the contiguous axis (ssd_scan.py copy_mode).
//   3. Cumsum: every thread of the first q loads one la at once; the sum
//      itself stays sequential in f32, in the plain version's order, in one
//      thread (128 dependent adds, under any cp.async still in flight).  A
//      warp-shuffle scan sums in another order, and at the scoring shape's
//      decays (|cs| up to ~1700, an f32 ulp of 1.2e-4) exp(cs_i - cs_j)
//      then moves y_intra by 1.3-2.9x the 3e-4 bar (tools/k8_scan_order.py).
//   4. The triangle: C B^T is cut into the 72 tiles of 16 rows x 8 keys on
//      or below the diagonal of the 8-row panels, 9 per warp.  M xbar runs
//      over 8-row panels, panel w paired with panel npan - 1 - w in warp w,
//      so every warp walks 136 keys at q = 128; each thread holds a 4 x 4
//      tile (one float4 of M^T and one of xbar per key, conflict-free).
//      (B o dte)^T xbar gives each thread 4 state rows x two 4-column
//      groups, 32 accumulators.
//   5. Tensor cores: for bf16 B/C, S = C B^T runs on mma.sync m16n8k16
//      (bf16 x bf16 -> f32; the products are exact, only the order of the
//      sums differs), C by ldmatrix.x4, B's rows straight as the col-major
//      operand by ldmatrix.x2; L = exp(cs_i - cs_j) and the causal zero are
//      applied to the accumulator fragments as M^T is written.  f32 B/C
//      compute the same tiles with f32 FFMAs (no TF32).  M xbar and the
//      state product stay f32 FFMAs: those are what the bound counts.
// Numerics: cs, dte, dfs and L are the plain version's (the same sequential
// sums, expf without fast math); S, y_intra and the states differ from it
// only in the order of the f32 sums, held to the reference's 3e-4.
// Measured on an H100 SXM at 700 W (PERF.md, K8's row): 0.28 ms at the
// scoring shape in the model's layout, 0.25 ms row-major; 40-47% of it is
// the state product, whose FFMAs run at under half the f32 rate
// (tools/k8_phases.py times the phases).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 9;      // S tiles per warp: 72 at q = 128 over 8 warps
constexpr int kMaxQ = 128;
enum DType : int { kF32 = 0, kBF16 = 1 };
enum Copy : int { kScalar = 0, kRows = 1, kCols = 2 };  // how a tile is staged

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
  int copy_bc, copy_x;  // Copy modes of B and C, and of xbar
};

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

// The block's shared memory, in bytes from its start
struct Layout {
  int qp;    // staged rows of B and C: q rounded up to 16
  int kp;    // staged state columns: n, rounded up to 16 for the mma
  int rs;    // row stride of staged B and C, in elements
  int npan;  // 8-row panels (and 8-key blocks) of the chunk
  int b_off, x_off, cs_off, dte_off, total;  // C (then M^T) at 0
};

template <typename T>
__host__ __device__ Layout layout(int q, int n, int p) {
  constexpr bool kBf = sizeof(T) == 2;
  Layout L;
  L.qp = up16(q);
  L.kp = kBf ? up16(n) : n;
  L.rs = L.kp + (kBf ? 8 : 4);  // 16 bytes of padding a row
  L.npan = (q + 7) / 8;
  const int mat = L.qp * L.rs * static_cast<int>(sizeof(T));
  const int mt = 4 * 32 * L.npan * (L.npan + 1);  // packed M^T panels, f32
  L.b_off = up16(mat > mt ? mat : mt);
  L.x_off = L.b_off + up16(mat);
  L.cs_off = L.x_off + up16(4 * q * p);
  L.dte_off = L.cs_off + 4 * kMaxQ;
  L.total = L.dte_off + 4 * kMaxQ;
  return L;
}

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
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// four consecutive values of shared memory as f32 (16- or 8-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void outer(float (&a)[16], float4 u, float4 w) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[4 * r + c] = fmaf(uu[r], ww[c], a[4 * r + c]);
}

__device__ __forceinline__ void store_rows(float* dst, long long stride,
                                           const float (&a)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(dst + r * stride) =
        make_float4(a[4 * r], a[4 * r + 1], a[4 * r + 2], a[4 * r + 3]);
}

// the kE values of a 16-byte load down a column, into kE rows of a tile
__device__ __forceinline__ void scatter(float* d, int ds, uint4 v) {
  d[0] = __uint_as_float(v.x);
  d[ds] = __uint_as_float(v.y);
  d[2 * ds] = __uint_as_float(v.z);
  d[3 * ds] = __uint_as_float(v.w);
}
__device__ __forceinline__ void scatter(__nv_bfloat16* d, int ds, uint4 v) {
  unsigned short* h = reinterpret_cast<unsigned short*>(d);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    h[2 * t * ds] = static_cast<unsigned short>(w[t] & 0xffffu);
    h[(2 * t + 1) * ds] = static_cast<unsigned short>(w[t] >> 16);
  }
}

// units (a, b) of a tile, numbered a * nb + b, taken tid, tid + kThreads,
// ...: a and b step on without a division in the loop
struct Walk {
  int a, b, da, db, nb;
  __device__ Walk(int tid, int n) : a(tid / n), b(tid % n), da(kThreads / n), db(kThreads % n), nb(n) {}
  __device__ void next() {
    a += da;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};

// rows x cols of `src` (row stride rs, column stride es) into shared memory
// at `dst` (row stride ds); entries past vrows or vcols are zero.  mode
// kRows: 16-byte cp.async along the rows (es == 1); kCols: 16-byte loads
// down the columns (rs == 1, the model's layout), lanes on neighbouring
// columns, 4 loads in flight a thread; kScalar: one element a load, lanes
// along the axis with the smaller stride, 4 in flight.  The wrapper picks
// the mode (ssd_scan.py copy_mode): 16-byte pieces lie whole and aligned
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ds, const T* src, long long rs,
                                      long long es, int rows, int vrows,
                                      int cols, int vcols, int mode, int tid) {
  constexpr int kE = 16 / sizeof(T);
  if (mode == kRows) {  // a: row, b: its 16-byte chunk
    for (Walk w(tid, cols / kE); w.a < rows; w.next()) {
      const int col = w.b * kE;
      const bool ok = w.a < vrows && col < vcols;
      cp_async16(smem_u32(dst + w.a * ds + col), ok ? src + w.a * rs + col : src, ok);
    }
  } else if (mode == kCols) {  // a: chunk of kE rows, b: column
    const int na = rows / kE;
    for (Walk w(tid, cols); w.a < na;) {
      uint4 v[4];
      int at[4], bt[4];
#pragma unroll
      for (int t = 0; t < 4; ++t, w.next()) {
        at[t] = w.a;
        bt[t] = w.b;
        v[t] = w.a < na && w.a * kE < vrows && w.b < vcols
                   ? __ldg(reinterpret_cast<const uint4*>(src + w.a * kE + w.b * es))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (at[t] < na) scatter(dst + at[t] * kE * ds + bt[t], ds, v[t]);
    }
  } else {  // a, b: row, column, or column, row where the rows are closer
    const bool down = rs < es;
    const int na = down ? cols : rows;
    for (Walk w(tid, down ? rows : cols); w.a < na;) {
      T v[4];
      int rt[4], kt[4];
#pragma unroll
      for (int t = 0; t < 4; ++t, w.next()) {
        rt[t] = w.a < na ? (down ? w.b : w.a) : -1;
        kt[t] = down ? w.a : w.b;
        v[t] = rt[t] >= 0 && rt[t] < vrows && kt[t] < vcols ? src[rt[t] * rs + kt[t] * es]
                                                            : zero<T>();
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (rt[t] >= 0) dst[rt[t] * ds + kt[t]] = v[t];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = P.q, n = P.n, p = P.p;
  const Layout L = layout<T>(q, n, p);
  T* cm = reinterpret_cast<T*>(smem);                      // C, then M^T
  T* bm = reinterpret_cast<T*>(smem + L.b_off);            // B
  float* xs = reinterpret_cast<float*>(smem + L.x_off);    // xbar (q x p)
  float* cs = reinterpret_cast<float*>(smem + L.cs_off);   // la, then cumsum
  float* dte = reinterpret_cast<float*>(smem + L.dte_off);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, g = h / P.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tg = lane % 4;  // the mma fragment coordinates
  const float* __restrict__ xg = P.x + b * P.sx[0] + c * P.sx[1] + h * P.sx[3];
  const float* __restrict__ lag = P.la + b * P.sla[0] + c * P.sla[1] + h * P.sla[3];
  const T* bg = static_cast<const T*>(P.B) + b * P.sb[0] + c * P.sb[1] + g * P.sb[3];
  const T* cg = static_cast<const T*>(P.C) + b * P.sc[0] + c * P.sc[1] + g * P.sc[3];

  stage<T>(cm, L.rs, cg, P.sc[2], P.sc[4], L.qp, q, L.kp, n, P.copy_bc, tid);
  stage<T>(bm, L.rs, bg, P.sb[2], P.sb[4], L.qp, q, L.kp, n, P.copy_bc, tid);
  cp_async_commit();
  stage<float>(xs, p, xg, P.sx[2], P.sx[4], q, q, p, p, P.copy_x, tid);
  cp_async_commit();

  // cumsum: la loaded by q threads at once, summed in order by one
  if (tid < q) cs[tid] = __ldg(lag + tid * P.sla[2]);
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
#pragma unroll 8
    for (int i = 0; i < q; ++i) {
      run += cs[i];
      cs[i] = run;
    }
  }

  // this warp's tiles of S = C B^T, 16 rows x 8 keys, numbered row by row
  // over those on or below the diagonal of the 8-row panels (tile row a
  // holds keys up to 16a + 15: min(2a + 2, npan) tiles), kSlots a warp
  const int na = L.qp / 16;
  int ta[kSlots], tb[kSlots];
  {
    int a = 0, t = kSlots * warp;
    while (a < na && t >= min(2 * a + 2, L.npan)) {
      t -= min(2 * a + 2, L.npan);
      ++a;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      ta[s] = a < na ? a : -1;
      tb[s] = t;
      if (a < na && ++t == min(2 * a + 2, L.npan)) {
        t = 0;
        ++a;
      }
    }
  }

  cp_async_wait<1>();  // B and C
  __syncthreads();

  float acc[kSlots][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  if constexpr (sizeof(T) == 2) {
    // ldmatrix lane offsets: A (C rows) x4, B (B rows, col-major operand) x2
    const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
    const int b_row = lane % 8, b_col = 8 * ((lane / 8) % 2);
    const uint32_t cbase = smem_u32(cm), bbase = smem_u32(bm);
    for (int kc = 0; kc < L.kp; kc += 16) {
      uint32_t af[4];
      int cur = -1;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (ta[s] < 0) break;
        if (ta[s] != cur) {
          cur = ta[s];
          ldsm_x4(cbase + 2 * ((16 * cur + a_row) * L.rs + kc + a_col), af);
        }
        uint32_t bf[2];
        ldsm_x2(bbase + 2 * ((8 * tb[s] + b_row) * L.rs + kc + b_col), bf);
        mma_bf16(acc[s], af, bf[0], bf[1]);
      }
    }
  } else {
    // the same tiles and fragment layout in f32 FFMAs
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (ta[s] < 0) break;
      const float* c0 = cm + (16 * ta[s] + gq) * L.rs;
      const float* c1 = c0 + 8 * L.rs;
      const float* b0 = bm + (8 * tb[s] + 2 * tg) * L.rs;
      const float* b1 = b0 + L.rs;
      for (int k = 0; k < n; k += 4) {
        const float4 u0 = ld4(c0 + k), u1 = ld4(c1 + k);
        const float4 w0 = ld4(b0 + k), w1 = ld4(b1 + k);
        const float uu[2][4] = {{u0.x, u0.y, u0.z, u0.w}, {u1.x, u1.y, u1.z, u1.w}};
        const float ww[2][4] = {{w0.x, w0.y, w0.z, w0.w}, {w1.x, w1.y, w1.z, w1.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            acc[s][e] = fmaf(uu[e >> 1][kk], ww[e & 1][kk], acc[s][e]);
      }
    }
  }
  __syncthreads();  // C is read for the last time: M^T takes its place

  // decay vectors: (b, nc, q, h) contiguous
  if (tid < q) {
    const float d = expf(cs[q - 1] - cs[tid]);
    dte[tid] = d;
    const long long o = ((static_cast<long long>(b) * P.nc + c) * q + tid) * P.h + h;
    P.dte[o] = d;
    P.dfs[o] = expf(cs[tid]);
  }

  // M^T[j, i] = S[i, j] exp(cs_i - cs_j) (0 past the diagonal or q), packed
  // by 8-row panel: panel r (rows 8r .. 8r + 7) holds keys 0 .. 8r + 7, 8
  // rows a key, from float 32 r (r + 1)
  float* mt = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (ta[s] < 0) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * ta[s] + gq + 8 * (e >> 1);
      const int j = 8 * tb[s] + 2 * tg + (e & 1);
      const int pan = i >> 3;
      if (pan < L.npan && j < 8 * (pan + 1))
        mt[32 * pan * (pan + 1) + 8 * j + (i & 7)] =
            i < q && j <= i ? acc[s][e] * expf(cs[i] - cs[j]) : 0.f;
    }
  }
  cp_async_wait<0>();  // xbar
  __syncthreads();

  // y_intra = M xbar: warp w takes panel w and panel npan - 1 - w; a lane
  // holds 4 rows x 4 columns (rows by lane / 16, columns by lane % 16)
  const long long ys = static_cast<long long>(P.h) * p;  // y's row stride
  float* yb = P.y + ((static_cast<long long>(b) * P.nc + c) * q * P.h + h) * p;
#pragma unroll 1
  for (int second = 0; second < 2; ++second) {
    if (warp >= (second ? L.npan / 2 : (L.npan + 1) / 2)) continue;
    const int pan = second ? L.npan - 1 - warp : warp;
    const int i0 = 8 * pan + 4 * (lane >> 4);
    const int kend = min(8 * (pan + 1), q);
    const float* mp = mt + 32 * pan * (pan + 1) + 4 * (lane >> 4);
    for (int c4 = 4 * (lane & 15); c4 < p; c4 += 64) {
      float a[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) a[r] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kend; ++j) outer(a, ld4(mp + 8 * j), ld4(xs + j * p + c4));
      if (i0 < q) store_rows(yb + i0 * ys + c4, ys, a);
    }
  }

  // state = (B o dte)^T xbar: 4 state rows x columns c0 .. c0 + 3 and
  // c0 + 4 ch .. c0 + 4 ch + 3 a thread
  const int ch = (p / 4 + 1) / 2;
  float* sb = P.st + ((static_cast<long long>(b) * P.nc + c) * P.h + h) * n * p;
  for (int u = tid; u < (n / 4) * ch; u += kThreads) {
    const int k4 = 4 * (u / ch), c0 = 4 * (u % ch), c1 = c0 + 4 * ch;
    const bool two = c1 < p;
    float a0[16], a1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 4
    for (int i = 0; i < q; ++i) {
      float4 bv = ld4(bm + i * L.rs + k4);
      const float d = dte[i];
      bv.x *= d;
      bv.y *= d;
      bv.z *= d;
      bv.w *= d;
      const float* xr = xs + i * p;
      outer(a0, bv, ld4(xr + c0));
      if (two) outer(a1, bv, ld4(xr + c1));
    }
    store_rows(sb + k4 * p + c0, p, a0);
    if (two) store_rows(sb + k4 * p + c1, p, a1);
  }
}

template <typename T>
int prepare(const Params& p, Layout* L) {
  *L = layout<T>(p.q, p.n, p.p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L->total);
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KB for shared memory as it gives: two blocks
  return cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t st) {
  Layout L;
  const int err = prepare<T>(p, &L);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<dim3(p.h, p.nc, batch), kThreads, L.total, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
int blocks_per_sm(const Params& p) {
  Layout L;
  int blocks = 0;
  if (prepare<T>(p, &L) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_chunk_kernel<T>,
                                                    kThreads, L.total) != cudaSuccess)
    return -1;
  return blocks;
}

Params params(const long long* dims) {
  Params p;
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
  p.copy_bc = static_cast<int>(dims[26]);
  p.copy_x = static_cast<int>(dims[27]);
  return p;
}

}  // namespace

extern "C" {

// dims: b, nc, q, h, p, g, n, then the element strides of xbar (5), la
// (4), B (5) and C (5), then the Copy modes of B and C and of xbar (which
// the caller has checked their layouts allow): 28 values, host memory.
// The outputs are contiguous.
// Launches on `stream` and returns cudaGetLastError(); an unknown dtype code
// returns cudaErrorInvalidValue without launching.  The wrapper checks
// q, n, p <= 128, each a multiple of 4, and h % g == 0.
int ssd_chunk_fwd(const void* xbar, const void* la, const void* B,
                  const void* C, void* y, void* states, void* dte, void* dfs,
                  const long long* dims, int dtype, void* stream) {
  Params p = params(dims);
  p.x = static_cast<const float*>(xbar);
  p.la = static_cast<const float*>(la);
  p.B = B;
  p.C = C;
  p.y = static_cast<float*>(y);
  p.st = static_cast<float*>(states);
  p.dte = static_cast<float*>(dte);
  p.dfs = static_cast<float*>(dfs);
  const int batch = static_cast<int>(dims[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(p, batch, st);
  if (dtype == kBF16) return launch<__nv_bfloat16>(p, batch, st);
  return cudaErrorInvalidValue;
}

// Blocks of ssd_chunk_fwd that one SM holds at once for these dims (as
// above) and dtype; -1 on an error.  Launches nothing.
int ssd_chunk_blocks_per_sm(const long long* dims, int dtype) {
  const Params p = params(dims);
  if (dtype == kF32) return blocks_per_sm<float>(p);
  if (dtype == kBF16) return blocks_per_sm<__nv_bfloat16>(p);
  return -1;
}

}  // extern "C"
