// Hand-written Hopper (sm_90a) kernels for chunked gated linear attention
// (GLA), the forward pass of the hymba SSD branch and the xLSTM mLSTM
// blocks. They replace the Pallas TPU kernel _gla_kernel / gla_forward_call
// of src/repro/kernels/gla.py, written from what it computes:
//
//   H_t = exp(ld_t) H_{t-1} + exp(li_t) k_t (x) v_t,    y_t = q_t . H_t
//
// evaluated chunk by chunk (chunk length L): per (batch.head) and chunk,
//   y     = (q k^T o W) v + diag(exp(clip(cum))) q H,
//   W_ij  = exp(clip(cum_i - cum_j + li_j)) for j <= i,
//   H    <- exp(clip(tot)) H + (k o exp(clip(tot - cum + li)))^T v,
// with cum the running sum of ld inside the chunk, tot its last entry,
// clip to [-80, 20], and H = 0 at the start of each (batch.head). The clips
// bite on sums within a chunk, so the chunk length defines the result and
// the kernels take the caller's.
//
// Layout: q, k [BH, S, N], v and y [BH, S, P], ld and li [BH, S], S a
// multiple of L. ld, li, the states and every product's accumulator are
// float32; q, k, v and y are float32 (the kernels below, templates on that
// type, T = float alone) or bfloat16 (kernels of their own, "bfloat16"
// below).
// bfloat16 rounds where the reference's kernel rounds: q k^T from the
// bfloat16 operands, q k^T o W rounded to bfloat16 before it multiplies v,
// the inter-chunk term and the state update from float32 (q o exp(cum),
// k o wj), and y rounded once as it is stored. The TPU kernel walks the
// chunks of a (batch.head) in order on its sequential grid axis. Here the
// walk is split in three launches on one stream, so that every chunk runs
// in parallel (bfloat16: the same three stages, gla_chunk_state_bf16,
// gla_state_pass and gla_chunk_output(_narrow)_bf16):
//
//   1. gla_chunk_state: grid (N-tile x P-tile, chunk, batch.head). Each
//      chunk's own state S_c = (k o wj)^T v into a float32 scratch
//      [BH, nc, N, P], and tot_c into [BH, nc]. The last chunk's state is
//      never read and is skipped.
//   2. gla_state_pass: elementwise over (batch.head, N.P), the recurrence
//      H_in(0) = 0, H_in(c+1) = H_in(c) exp(clip(tot_c)) + S_c, in place
//      over the scratch (multiply, then add, as the reference does).
//   3. y of every chunk from q, k, v and H_in(c): gla_chunk_output_narrow
//      for N <= 16 (one CTA a chunk, walking P), gla_chunk_output for wider
//      states (one CTA a chunk and 64 columns of P, q and k streamed over N).
//
// The products run on the tensor cores: mma.sync m16n8k8 with tf32
// operands and float32 accumulators, in the 3xTF32 split (x = big + small,
// both tf32; a.b ~ a_s.b_b + a_b.b_s + a_b.b_b), which keeps float32
// accuracy where plain tf32 keeps about three decimal digits. mma.sync and
// not wgmma: tf32 wgmma takes K-major operands only, and v (the B operand
// of A v) and k (the A operand of (k o wj)^T v) are MN-major here. Each
// warp loads its fragments from shared memory with row strides chosen so
// that the 32 lanes of a fragment load hit 32 banks. In stage 3 the
// weighted q k^T never leaves the registers: the m16n8 accumulator of
// columns j0..j0+7 holds, in lane (g, t), columns 2t and 2t+1 of rows g
// and g+8, which is an A fragment of the same rows if the MMA's k index t
// stands for column 2t and t+4 for 2t+1; the B fragment (rows of v) takes
// the same order. Tiles whose N, P or L is not a multiple of the MMA shape
// are padded with zeros in shared memory. Global loads are cp.async
// (16 bytes where rows allow, else 4), issued ahead of the tile they feed.
// Masked entries (j > i) are skipped. In the reference they are
// exp(-80) ~ 1.8e-35 times q.k, not 0; the difference is below float32's
// resolution of any unmasked term. The N <= 16 kernel makes a chunk's
// weights from an exp a row and an exp a column where it can (see there),
// the others from an exp an entry.
//
// What bounds it on an H100 at the hymba-1.5B SSD shape (B=4, S=4096,
// H=25, N=16, P=128, L=128, so BH=100, nc=32): the bytes. Inputs read and
// output written once are 4 B x 100 x 4096 x (2.16 + 2.128 + 2) = 475 MB,
// 0.142 ms at 3.35 TB/s; the 5.4 G multiply-adds of the causal products,
// at three tf32 MMAs each, take 0.066 ms at the dense 495 TF32 TFLOP/s
// (0.162 ms as float32 FMAs at 67 TFLOP/s); mma.sync issues below the
// dense rate, and every MMA here needs its operands split and loaded from
// shared memory. Chunk parallelism costs bytes: v is read twice and the
// states (26 MB) go through HBM four times, about 818 MB and 0.244 ms in
// all. In exchange the card gets 6,200 + 3,200 CTAs at hymba width (the
// single walk had 200) and 1,008 + 160 at the xLSTM-350M head shape
// (N=256, P=257; it had 20), two to four of them an SM. A later design
// can fuse stages 1 and 3 in a wavefront to read v once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 128;          // longest chunk
constexpr float kClipLo = -80.0f, kClipHi = 20.0f;
constexpr float kWeightLo = 1.80485139e-35f;   // exp(-80)
constexpr float kWeightHi = 4.85165195e8f;     // exp(20)

// Stage 1: 4 warps, each a 16 x (8 NTW) tile of S_c (StateTile).
constexpr int kStateThreads = 128;
// Stage 3: 8 warps, each 16 rows of the chunk by kPT columns (OutTile).
constexpr int kOutThreads = 256;
constexpr int kPT = 64;             // columns of P an output CTA owns
constexpr int kNT = 16;             // columns of N in a q/k tile
// Row strides in floats. A lane (g, t) of a fragment load reads row t or
// 2t and column g (B operands, stride = 8 or 4 mod 32) or row g and column
// t (A operands, stride = 4 mod 8): conflict-free, and 16-byte rows.
constexpr int kQKStride = kNT + 4;  // q, k tiles of stage 3
constexpr int kSmemMax = 232448;    // what an H100 CTA may opt into

__device__ __forceinline__ float clipped_exp(float x) {
  return expf(fminf(fmaxf(x, kClipLo), kClipHi));
}

__device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// --- asynchronous copies --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies `bytes` (0 to 16) from src and zero-fills the rest of 16 bytes.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Waits until at most `pending` (0 to 3) of the latest groups are in
// flight.
__device__ __forceinline__ void cp_wait_upto(int pending) {
  if (pending <= 0) cp_wait<0>();
  else if (pending == 1) cp_wait<1>();
  else if (pending == 2) cp_wait<2>();
  else cp_wait<3>();
}

// rows x cols floats of a row-major global matrix (row stride gs floats;
// rows_in x cols_in of them exist) into shared memory at row stride ss,
// zeros elsewhere. vec: 16-byte copies (gs, the tile's first column and
// the base 16-byte aligned; cols a multiple of 4).
__device__ __forceinline__ void load_tile(float* dst, int ss,
                                          const float* src, size_t gs,
                                          int rows, int cols, int rows_in,
                                          int cols_in, bool vec, int tid,
                                          int nthreads) {
  if (vec) {
    const int cv = cols / 4;
    for (int e = tid; e < rows * cv; e += nthreads) {
      const int r = e / cv, c = (e - r * cv) * 4;
      const int n = r < rows_in ? min(4, max(0, cols_in - c)) : 0;
      cp16(dst + r * ss + c, n ? src + r * gs + c : src, 4 * n);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, c = e - r * cols;
      const bool in = r < rows_in && c < cols_in;
      cp4(dst + r * ss + c, in ? src + r * gs + c : src, in ? 4 : 0);
    }
  }
}

// Stores an accumulator pair, columns col and col + 1 of a row (as one
// 8-byte store where the row allows), of which `left` exist.
__device__ __forceinline__ void store_pair(float* dst, float a, float b,
                                           int left, bool even) {
  if (even && left >= 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    if (left >= 1) dst[0] = a;
    if (left >= 2) dst[1] = b;
  }
}

// --- 3xTF32 tensor-core products ------------------------------------------

struct Tf32 {
  uint32_t big, small;
};

// x = big + small, each rounded to tf32 to nearest, ties away from zero
// (cvt.rna.tf32.f32) by adding half of tf32's last place to the magnitude:
// the MMA reads the top 19 bits of an operand and ignores the low 13, so
// only the small part's subtraction needs them cleared. Integer adds run
// at four times the rate of the conversion instruction (CUDA C++
// Programming Guide, arithmetic instruction throughput, sm_90).
__device__ __forceinline__ Tf32 split(float x) {
  const uint32_t big = __float_as_uint(x) + 0x1000u;
  const float rest = x - __uint_as_float(big & 0xffffe000u);
  return Tf32{big, __float_as_uint(rest) + 0x1000u};
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8): a[0] (g, t), a[1] (g+8, t), a[2] (g, t+4),
// a[3] (g+8, t+4), split.
struct FragA {
  Tf32 a[4];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  return FragA{{split(a0), split(a1), split(a2), split(a3)}};
}

// c[i] += A B_i for M accumulators at float32 accuracy, B_i (8 x 8) given
// split as b0[i] (t, g) and b1[i] (t+4, g). The three products run as three
// passes over the M accumulators, small products first, so that the MMAs
// between two into the same accumulator are independent: a chain of
// dependent MMAs would wait out the tensor pipe's latency at every step.
// AX (BX): every entry of A (B) is exact in tf32 (a widened bfloat16), so
// its small parts are 0 and the pass that multiplies them is skipped.
template <int M, bool AX = false, bool BX = false>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA& f,
                                     const Tf32 (&b0)[M],
                                     const Tf32 (&b1)[M]) {
  if constexpr (!AX) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      mma(c[i], f.a[0].small, f.a[1].small, f.a[2].small, f.a[3].small,
          b0[i].big, b1[i].big);
  }
  if constexpr (!BX) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      mma(c[i], f.a[0].big, f.a[1].big, f.a[2].big, f.a[3].big, b0[i].small,
          b1[i].small);
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
    mma(c[i], f.a[0].big, f.a[1].big, f.a[2].big, f.a[3].big, b0[i].big,
        b1[i].big);
}

// The chunk's gates, 4 entries a lane of warp 0 (entries l..kMaxL are 0).
// A kernel loads them first, so that they do not queue behind its tiles.
struct Gates {
  float ld[4], li[4];
};

__device__ __forceinline__ Gates gate_load(const float* ldc, const float* lic,
                                           int l, int tid) {
  Gates gt = {};
  if (tid < 32) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * tid + r;
      gt.ld[r] = i < l ? ldc[i] : 0.0f;
      gt.li[r] = i < l ? lic[i] : 0.0f;
    }
  }
  return gt;
}

// cum, the inclusive running sum of ld (a warp-parallel scan by warp 0),
// and li into shared memory. Every thread calls it; it ends on a barrier.
__device__ __forceinline__ void gate_scan(const Gates& gt, float* cum,
                                          float* lis, int tid) {
  if (tid < 32) {
    float x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = r ? x[r - 1] + gt.ld[r] : gt.ld[0];
    float incl = x[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      cum[4 * tid + r] = x[r] + excl;
      lis[4 * tid + r] = gt.li[r];
    }
  }
  __syncthreads();
}

// --- stage 1: each chunk's own state -----------------------------------------

// The CTA tile of S_c: WM warps down N (16 rows each) by 4 / WM across P
// (8 NTW columns each). Shared memory in floats: k [Lp][16 WM + 8],
// v [Lp][CTA columns + 8], cum, li and wj [kMaxL].
template <int WM, int NTW>
struct StateTile {
  static constexpr int NT = 16 * WM, PT = 4 / WM * 8 * NTW;
  static constexpr int KS = NT + 8, VS = PT + 8;
  static size_t smem_floats(int lp) {
    return (size_t)lp * (KS + VS) + 3 * kMaxL;
  }
};

template <typename T, int WM, int NTW>
__global__ void __launch_bounds__(kStateThreads) gla_chunk_state(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ li,
    float* __restrict__ states, float* __restrict__ tot, int S, int N, int P,
    int L, int vec_k, int vec_v) {
  using Tile = StateTile<WM, NTW>;
  constexpr int NT = Tile::NT, PT = Tile::PT, KS = Tile::KS, VS = Tile::VS;
  extern __shared__ __align__(16) float sm[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int tiles_p = (P + PT - 1) / PT;
  const int n0 = (blockIdx.x / tiles_p) * NT, p0 = (blockIdx.x % tiles_p) * PT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);
  float* ks = sm;
  float* vs = ks + (size_t)lp * KS;
  float* cum = vs + (size_t)lp * VS;
  float* lis = cum + kMaxL;
  float* wj = lis + kMaxL;

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  // Slabs of 32 rows of the chunk, one copy group each, in order.
  const int slabs = lp / 32;
  for (int s = 0; s < slabs; ++s) {
    const int r0 = 32 * s, rows_in = max(0, min(32, L - r0));
    load_tile(ks + r0 * KS, KS, k + (row0 + r0) * N + n0, N, 32, NT,
              rows_in, N - n0, vec_k, tid, kStateThreads);
    load_tile(vs + r0 * VS, VS, v + (row0 + r0) * P + p0, P, 32, PT,
              rows_in, P - p0, vec_v, tid, kStateThreads);
    cp_commit();
  }
  gate_scan(gt, cum, lis, tid);
  const float total = cum[L - 1];
  for (int j = tid; j < lp; j += kStateThreads)
    wj[j] = j < L ? clipped_exp(total - cum[j] + lis[j]) : 0.0f;
  if (blockIdx.x == 0 && tid == 0) tot[(size_t)bh * nc + c] = total;

  // Warp tile: rows 16 wm.. of the CTA's N tile, columns 8 NTW wn.. of its P.
  const int wm = warp % WM, wn = warp / WM;
  const int rn = 16 * wm, cp0 = 8 * NTW * wn;
  const bool active = n0 + rn < N && p0 + cp0 < P;
  float acc[NTW][4] = {};
  for (int s = 0; s < slabs; ++s) {
    cp_wait_upto(slabs - 1 - s);
    __syncthreads();                  // this slab's copies and wj visible
    if (!active) continue;
    const int jend = min(32 * s + 32, round_up(L, 8));
    for (int j0 = 32 * s; j0 < jend; j0 += 8) {
      // A[n][j] = k[j][n] wj[j]: rows n (g, g+8), columns j (t, t+4).
      const float w0 = wj[j0 + t], w1 = wj[j0 + t + 4];
      const float* k0 = ks + (j0 + t) * KS + rn + g;
      const float* k1 = k0 + 4 * KS;
      const FragA a = frag_a(k0[0] * w0, k0[8] * w0, k1[0] * w1, k1[8] * w1);
      const float* v0 = vs + (j0 + t) * VS + cp0 + g;
      Tf32 b0[NTW], b1[NTW];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        b0[nt] = split(v0[8 * nt]);
        b1[nt] = split(v0[8 * nt + 4 * VS]);
      }
      mma3<NTW>(acc, a, b0, b1);   // (k o wj) v
    }
  }
  if (!active) return;
  float* out = states + (((size_t)bh * nc + c) * N + n0 + rn) * P + p0 + cp0;
  const bool even = (P & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = 8 * nt + 2 * t, left = P - p0 - cp0 - col;
    if (n0 + rn + g < N)
      store_pair(out + (size_t)g * P + col, acc[nt][0], acc[nt][1], left,
                 even);
    if (n0 + rn + g + 8 < N)
      store_pair(out + (size_t)(g + 8) * P + col, acc[nt][2], acc[nt][3],
                 left, even);
  }
}

// --- stage 2: the recurrence over chunks -------------------------------------

// A thread a state entry, walking the chunks in order, 32 at a time: a
// load waits out the memory's latency, so the 32 chunks' entries are all
// read before the first is written, and each lane of a warp takes one
// chunk's exp(clip(tot)) and hands it round by shuffles.
__global__ void __launch_bounds__(256) gla_state_pass(
    float* __restrict__ states, const float* __restrict__ tot, int nc,
    int np) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, lane = threadIdx.x & 31;
  const bool in = e < np;              // every lane takes part in shuffles
  const size_t bh = blockIdx.y;
  float* h = states + bh * nc * np + e;
  const float* tb = tot + bh * nc;
  float acc = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    // The last chunk's state and tot are never written, nor needed.
    const float decay = c0 + lane + 1 < nc ? clipped_exp(tb[c0 + lane]) : 0.0f;
    float s[32];                       // S_c, read before H_in(c) replaces it
#pragma unroll
    for (int u = 0; u < 32; ++u)
      s[u] = in && c0 + u + 1 < nc ? h[(size_t)(c0 + u) * np] : 0.0f;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float d = __shfl_sync(0xffffffffu, decay, u);
      if (c0 + u < nc) {
        if (in) h[(size_t)(c0 + u) * np] = acc;
        acc = __fadd_rn(__fmul_rn(acc, d), s[u]);
      }
    }
  }
}

// --- stage 3: each chunk's output ---------------------------------------------

// Stage 3 for N > kNT (xLSTM's N = 256): one CTA a (batch.head, chunk,
// kPT columns of P). q, k and H are streamed over N in double-buffered
// tiles, q k^T and q H accumulate in the same stream, and every B operand
// is split where it is used. Shared memory in floats:
// q and k [2][Lp][kQKStride], H [2][kNT][HS], v [Lp][VS], cum, li and
// exp(cum) [kMaxL].
struct OutTile {
  // Lanes (g, t) of a B fragment read rows t, 2t or g and columns g or t:
  // these strides keep a fragment load on 32 banks.
  static constexpr int KS = kQKStride, HS = kPT + 8, VS = kPT + 4;
  static size_t smem_floats(int lp) {
    return 2 * ((size_t)lp * (kQKStride + KS) + kNT * HS) +
           (size_t)lp * VS + 3 * kMaxL;
  }
};

// Element (row, col) of a B operand in a row-major shared tile: a raw
// float split here, or a (big, small) pair split before.
template <bool PAIRS>
__device__ __forceinline__ Tf32 b_entry(const float* tile, int stride,
                                        int row, int col) {
  if (PAIRS) {
    const float2 x =
        *reinterpret_cast<const float2*>(tile + row * stride + 2 * col);
    return Tf32{__float_as_uint(x.x), __float_as_uint(x.y)};
  }
  return split(tile[row * stride + col]);
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads, 2) gla_chunk_output(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ li, const float* __restrict__ h_in,
    T* __restrict__ y, int S, int N, int P, int L, int vec_qk,
    int vec_vh) {
  constexpr int KS = OutTile::KS, HS = OutTile::HS, VS = OutTile::VS;
  constexpr int NP8 = kPT / 8;
  extern __shared__ __align__(16) float sm[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int p0 = blockIdx.x * kPT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);       // whole groups of four column tiles
  float* qs = sm;                                    // [2][lp][kQKStride]
  float* ks = qs + 2 * (size_t)lp * kQKStride;       // [2][lp][KS]
  float* hs = ks + 2 * (size_t)lp * KS;              // [2][kNT][HS]
  float* vs = hs + 2 * kNT * HS;                     // [lp][VS]
  float* cum = vs + (size_t)lp * VS;
  float* lis = cum + kMaxL;
  float* ei = lis + kMaxL;

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const bool carry = c > 0;            // H_in(0) = 0: no q H term
  const float* hb = h_in + ((size_t)bh * nc + c) * N * P + p0;
  const int tiles = (N + kNT - 1) / kNT;
  auto issue = [&](int it) {
    const int n0 = it * kNT, b = it & 1;
    load_tile(qs + b * lp * kQKStride, kQKStride, q + row0 * N + n0, N, lp,
              kNT, L, N - n0, vec_qk, tid, kOutThreads);
    load_tile(ks + b * lp * KS, KS, k + row0 * N + n0, N, lp, kNT, L, N - n0,
              vec_qk, tid, kOutThreads);
    if (carry)
      load_tile(hs + b * kNT * HS, HS, hb + (size_t)n0 * P, P, kNT, kPT,
                N - n0, P - p0, vec_vh, tid, kOutThreads);
  };
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  issue(0);
  cp_commit();
  load_tile(vs, VS, v + row0 * P + p0, P, lp, kPT, L, P - p0, vec_vh, tid,
            kOutThreads);
  cp_commit();
  gate_scan(gt, cum, lis, tid);
  for (int i = tid; i < lp; i += kOutThreads)
    ei[i] = i < L ? clipped_exp(cum[i]) : 0.0f;

  // Warp w owns rows 16 rb.. of the chunk, rb = w for w < 4 and 11 - w
  // above, so that the warps sharing a scheduler (w, w + 4) hold row blocks
  // rb and 7 - rb: equal causal work at L = 128.
  const int rb = warp < 4 ? warp : 11 - warp;
  const int r0 = 16 * rb;
  const bool active = r0 < L;
  // Column tiles j of q k^T that hold causal entries: j <= r0 + 15.
  const int jt_end = min(2 * rb + 2, round_up(L, 8) / 8);
  float acc_a[16][4] = {};                 // (q k^T) rows r0.., cols 8 jt..
  float acc_y[NP8][4] = {};                // (q H)   rows r0.., cols 8 pt..
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) issue(it + 1);
    cp_commit();                           // (empty past the last tile)
    if (it == 0) cp_wait<2>(); else cp_wait<1>();
    __syncthreads();
    const int b = it & 1;
    const float* qt = qs + b * lp * kQKStride;
    const float* kt = ks + b * lp * KS;
    const float* ht = hs + b * kNT * HS;
    if (active) {
#pragma unroll
      for (int n8 = 0; n8 < kNT; n8 += 8) {
        const float* qa = qt + (r0 + g) * kQKStride + n8 + t;
        const FragA a = frag_a(qa[0], qa[8 * kQKStride], qa[4],
                               qa[8 * kQKStride + 4]);
        // B[n][j] = k[j][n]: lane (g, t) takes k[8 jt + g][n8 + t (+4)],
        // four column tiles at a time (past jt_end: zero rows or masked).
#pragma unroll
        for (int j4 = 0; j4 < 16; j4 += 4) {
          if (j4 < jt_end) {
            Tf32 b0[4], b1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              b0[i] = b_entry<false>(kt, KS, 8 * (j4 + i) + g, n8 + t);
              b1[i] = b_entry<false>(kt, KS, 8 * (j4 + i) + g, n8 + t + 4);
            }
            mma3<4>(acc_a + j4, a, b0, b1);  // q k^T
          }
        }
        if (carry) {
#pragma unroll
          for (int p4 = 0; p4 < NP8; p4 += 4) {
            Tf32 b0[4], b1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              b0[i] = b_entry<false>(ht, HS, n8 + t, 8 * (p4 + i) + g);
              b1[i] = b_entry<false>(ht, HS, n8 + t + 4, 8 * (p4 + i) + g);
            }
            mma3<4>(acc_y + p4, a, b0, b1);           // q H
          }
        }
      }
    }
    __syncthreads();                       // the buffer is free for it + 2
  }

  // q k^T o W. Accumulator lane (g, t) holds columns j = 8 jt + 2t, 2t + 1
  // of rows i0, i1; W = exp(clip(cum_i - cum_j + li_j)) in the reference's
  // order, 0 above the diagonal and outside the chunk.
  const int i0 = r0 + g, i1 = i0 + 8;
  if (active) {
    const float c0 = cum[i0], c1 = cum[i1];
#pragma unroll
    for (int jt = 0; jt < 16; ++jt) {
      if (jt < jt_end) {
        const int ja = 8 * jt + 2 * t, jb = ja + 1;
        acc_a[jt][0] *= ja <= i0 && i0 < L
                            ? clipped_exp(c0 - cum[ja] + lis[ja]) : 0.0f;
        acc_a[jt][1] *= jb <= i0 && i0 < L
                            ? clipped_exp(c0 - cum[jb] + lis[jb]) : 0.0f;
        acc_a[jt][2] *= ja <= i1 && i1 < L
                            ? clipped_exp(c1 - cum[ja] + lis[ja]) : 0.0f;
        acc_a[jt][3] *= jb <= i1 && i1 < L
                            ? clipped_exp(c1 - cum[jb] + lis[jb]) : 0.0f;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                         // v visible
  if (!active) return;

  // y = exp(cum) o (q H) + (q k^T o W) v. The weighted accumulator is the
  // A fragment whose k index t is column 2t and t + 4 is 2t + 1; the rows
  // of v (B) follow that order.
  const float e0 = ei[i0], e1 = ei[i1];
#pragma unroll
  for (int pt = 0; pt < NP8; ++pt) {
    acc_y[pt][0] *= e0;
    acc_y[pt][1] *= e0;
    acc_y[pt][2] *= e1;
    acc_y[pt][3] *= e1;
  }
#pragma unroll
  for (int jt = 0; jt < 16; ++jt) {
    if (jt < jt_end) {
      const FragA a = frag_a(acc_a[jt][0], acc_a[jt][2], acc_a[jt][1],
                             acc_a[jt][3]);
      const int ja = 8 * jt + 2 * t;
#pragma unroll
      for (int p4 = 0; p4 < NP8; p4 += 4) {
        Tf32 b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] = b_entry<false>(vs, VS, ja, 8 * (p4 + i) + g);
          b1[i] = b_entry<false>(vs, VS, ja + 1, 8 * (p4 + i) + g);
        }
        mma3<4>(acc_y + p4, a, b0, b1);  // (.) v
      }
    }
  }
  T* yb = y + row0 * P + p0;
  const bool even = (P & 1) == 0;
#pragma unroll
  for (int pt = 0; pt < NP8; ++pt) {
    const int col = 8 * pt + 2 * t;
    if (i0 < L)
      store_pair(yb + (size_t)i0 * P + col, acc_y[pt][0], acc_y[pt][1],
                 P - p0 - col, even);
    if (i1 < L)
      store_pair(yb + (size_t)i1 * P + col, acc_y[pt][2], acc_y[pt][3],
                 P - p0 - col, even);
  }
}

// Stage 3 for N <= kNT (hymba's SSD branch, N = 16), where q and k are one
// tile. q k^T is made four column tiles (32 columns) at a time, weighted
// and multiplied into v at once, as flash attention does, so that no warp
// holds more than two 16 x 32 blocks of it. Four warps, warp w owning row
// blocks w and 7 - w: equal causal work at L = 128, and every B fragment
// (k, v) that a warp loads and splits serves both of its row blocks. k is
// split into (big, small) tf32 pairs in shared memory once.
//
// The weights would cost an exp for every causal entry and P-tile. As exp
// is monotonic, W_ij = exp(clip(cum_i - cum_j + li_j)) is the product
// er_i ec_j clipped to [exp(-80), exp(20)], with er_i = exp(cum_i - m) and
// ec_j = exp(li_j - cum_j + m) for any shift m: exps a row and a column
// instead of an entry, and the weights stay what the reference's are,
// clip included (see weights_factor). A chunk whose gates leave no such m
// (cum or li - cum spanning more than 160 within it, for one) takes each
// entry's own clipped exp.
//
// A CTA walks `per` P-tiles of its chunk, so that the chunk's gates, q
// and k (and their split) are made once for all of them; the other CTAs on
// its SM hide the wait for each tile's v and H (a second buffer would leave
// room for two CTAs an SM, and measured slower). Shared memory in floats:
// q [Lp][kQKStride], k pairs [Lp][KS], v [Lp][VS], H [kNT][HS], cum, li,
// exp(clip(cum)), er and ec [kMaxL]: 71 KB at L = 128, three CTAs an SM.
// The row factors are read from shared memory where they are used: held
// in registers they cost spills under the 168 registers of three CTAs.
constexpr int kNarrowThreads = 128;
constexpr int kNarrowPT = 64;

struct NarrowTile {
  static constexpr int KS = 2 * kNT + 8;          // k pairs, B rows g
  static constexpr int HS = kNarrowPT + 8;        // H raw, B rows t
  static constexpr int VS = kNarrowPT + 4;        // v raw, B rows 2t
  static size_t smem_floats(int lp) {
    return (size_t)lp * (kQKStride + KS + VS) + kNT * HS + 5 * kMaxL;
  }
};

// k's rows (kNT raw floats at the start of each) to (big, small) pairs in
// place; warp w takes rows w, w + 4, ...
__device__ __forceinline__ void split_k_rows(float* tile, int stride,
                                             int rows, int warp, int lane) {
  static_assert(kNT <= 32, "a lane a column");
  for (int r = warp; r < rows; r += kNarrowThreads / 32) {
    float* row = tile + r * stride;
    const float x = lane < kNT ? row[lane] : 0.0f;
    __syncwarp();
    if (lane < kNT) {
      const Tf32 sx = split(x);
      reinterpret_cast<float2*>(row)[lane] =
          make_float2(__uint_as_float(sx.big), __uint_as_float(sx.small));
    }
  }
}

// Two row blocks' products with one B: c0 += A0 B, c1 += A1 B, the three
// passes interleaved over all eight accumulators (AX, BX as for mma3).
template <bool AX = false, bool BX = false>
__device__ __forceinline__ void mma3_pair(float (*c0)[4], const FragA& f0,
                                          float (*c1)[4], const FragA& f1,
                                          const Tf32 (&b0)[4],
                                          const Tf32 (&b1)[4]) {
  if constexpr (!AX) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mma(c0[i], f0.a[0].small, f0.a[1].small, f0.a[2].small,
          f0.a[3].small, b0[i].big, b1[i].big);
      mma(c1[i], f1.a[0].small, f1.a[1].small, f1.a[2].small,
          f1.a[3].small, b0[i].big, b1[i].big);
    }
  }
  if constexpr (!BX) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mma(c0[i], f0.a[0].big, f0.a[1].big, f0.a[2].big, f0.a[3].big,
          b0[i].small, b1[i].small);
      mma(c1[i], f1.a[0].big, f1.a[1].big, f1.a[2].big, f1.a[3].big,
          b0[i].small, b1[i].small);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mma(c0[i], f0.a[0].big, f0.a[1].big, f0.a[2].big, f0.a[3].big,
        b0[i].big, b1[i].big);
    mma(c1[i], f1.a[0].big, f1.a[1].big, f1.a[2].big, f1.a[3].big,
        b0[i].big, b1[i].big);
  }
}

// Rows g and g + 8 of two row blocks' accumulators times e[0..3].
__device__ __forceinline__ void scale_rows(float (*y0)[4], float (*y1)[4],
                                           const float (&e)[4]) {
#pragma unroll
  for (int pt = 0; pt < kNarrowPT / 8; ++pt) {
    y0[pt][0] *= e[0];
    y0[pt][1] *= e[0];
    y0[pt][2] *= e[1];
    y0[pt][3] *= e[1];
    y1[pt][0] *= e[2];
    y1[pt][1] *= e[2];
    y1[pt][2] *= e[3];
    y1[pt][3] *= e[3];
  }
}

// c += A B for the row blocks that take part (do0, do1).
template <bool AX = false, bool BX = false>
__device__ __forceinline__ void mma3_blocks(bool do0, float (*c0)[4],
                                            const FragA& f0, bool do1,
                                            float (*c1)[4], const FragA& f1,
                                            const Tf32 (&b0)[4],
                                            const Tf32 (&b1)[4]) {
  if (do0 && do1)
    mma3_pair<AX, BX>(c0, f0, c1, f1, b0, b1);
  else if (do0)
    mma3<4, AX, BX>(c0, f0, b0, b1);
  else if (do1)
    mma3<4, AX, BX>(c1, f1, b0, b1);
}

// Whether a shift m puts both factors' exponents, cum_i - m and
// li_j - cum_j + m for i, j < l, inside [-80, 80], and that m (the middle
// of those that do). Then er_i and ec_j are normal floats, their product is
// exp(cum_i - cum_j + li_j) up to rounding, and where it overflows or
// underflows the exponent is past a clip, which the clamp of the product
// restores (clip_weight). Every warp reduces the same values in the same
// order, so every warp decides alike.
__device__ __forceinline__ bool weights_factor(const float* cum,
                                               const float* lis, int l,
                                               int lane, float* shift) {
  float a_lo = 3.0e38f, a_hi = -3.0e38f, b_lo = 3.0e38f, b_hi = -3.0e38f;
  for (int i = lane; i < l; i += 32) {
    a_lo = fminf(a_lo, cum[i]);
    a_hi = fmaxf(a_hi, cum[i]);
    b_lo = fminf(b_lo, lis[i] - cum[i]);
    b_hi = fmaxf(b_hi, lis[i] - cum[i]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a_lo = fminf(a_lo, __shfl_xor_sync(0xffffffffu, a_lo, o));
    a_hi = fmaxf(a_hi, __shfl_xor_sync(0xffffffffu, a_hi, o));
    b_lo = fminf(b_lo, __shfl_xor_sync(0xffffffffu, b_lo, o));
    b_hi = fmaxf(b_hi, __shfl_xor_sync(0xffffffffu, b_hi, o));
  }
  const float lo = fmaxf(a_hi + kClipLo, kClipLo - b_lo);
  const float hi = fminf(a_lo - kClipLo, -kClipLo - b_hi);
  *shift = 0.5f * (lo + hi);
  return lo <= hi;
}

// exp(clip(x)) from e = exp(x), which may have overflowed or underflowed.
__device__ __forceinline__ float clip_weight(float e) {
  return fminf(fmaxf(e, kWeightLo), kWeightHi);
}

template <typename T>
__global__ void __launch_bounds__(kNarrowThreads, 3) gla_chunk_output_narrow(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ li, const float* __restrict__ h_in,
    T* __restrict__ y, int S, int N, int P, int L, int per, int vec_qk,
    int vec_vh) {
  constexpr int KS = NarrowTile::KS, HS = NarrowTile::HS;
  constexpr int VS = NarrowTile::VS, NP8 = kNarrowPT / 8;
  static_assert(NP8 % 4 == 0, "B groups of four column tiles");
  extern __shared__ __align__(16) float sm[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int tile0 = blockIdx.x * per;
  const int tile1 = min(tile0 + per, (P + kNarrowPT - 1) / kNarrowPT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);       // whole groups of four column tiles
  float* qs = sm;                                  // [lp][kQKStride]
  float* ks = qs + (size_t)lp * kQKStride;         // [lp][KS]
  float* vs = ks + (size_t)lp * KS;                // [lp][VS]
  float* hs = vs + (size_t)lp * VS;                // [kNT][HS]
  float* cum = hs + kNT * HS;
  float* lis = cum + kMaxL;
  float* ei = lis + kMaxL;
  float* er = ei + kMaxL;                          // row factors
  float* ec = er + kMaxL;                          // column factors

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const bool carry = c > 0;            // H_in(0) = 0: no q H term
  const float* hc = h_in + ((size_t)bh * nc + c) * N * P;
  // v and H_in's columns of P-tile j.
  auto issue_tile = [&](int j) {
    const int p0 = j * kNarrowPT;
    load_tile(vs, VS, v + row0 * P + p0, P, lp, kNarrowPT, L, P - p0, vec_vh,
              tid, kNarrowThreads);
    if (carry)
      load_tile(hs, HS, hc + p0, P, kNT, kNarrowPT, N, P - p0, vec_vh, tid,
                kNarrowThreads);
  };
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  load_tile(qs, kQKStride, q + row0 * N, N, lp, kNT, L, N, vec_qk, tid,
            kNarrowThreads);
  load_tile(ks, KS, k + row0 * N, N, lp, kNT, L, N, vec_qk, tid,
            kNarrowThreads);
  cp_commit();
  issue_tile(tile0);
  cp_commit();
  gate_scan(gt, cum, lis, tid);
  float m;
  const bool factored = weights_factor(cum, lis, L, lane, &m);
  for (int i = tid; i < lp; i += kNarrowThreads) {
    ei[i] = i < L ? clipped_exp(cum[i]) : 0.0f;
    er[i] = factored && i < L ? expf(cum[i] - m) : 0.0f;
    ec[i] = factored && i < L ? expf(lis[i] - cum[i] + m) : 0.0f;
  }
  cp_wait<1>();                        // q and k
  __syncthreads();
  split_k_rows(ks, KS, lp, warp, lane);
  __syncthreads();

  // Row blocks: lo = warp, hi = 7 - warp; the column tiles j of q k^T
  // that hold causal entries of a block at r0: j <= r0 + 15.
  const int r_lo = 16 * warp, r_hi = 16 * (7 - warp);
  const int tiles_l = round_up(L, 8) / 8;
  const int jt_lo = r_lo < L ? min(2 * warp + 2, tiles_l) : 0;
  const int jt_hi = r_hi < L ? min(16 - 2 * warp, tiles_l) : 0;
  const int jt_end = max(jt_lo, jt_hi);
  FragA qf[2][kNT / 8];                // q of each block, each k step
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n8 = 0; n8 < kNT; n8 += 8) {
      const float* qa = qs + ((h ? r_hi : r_lo) + g) * kQKStride + n8 + t;
      qf[h][n8 / 8] =
          frag_a(qa[0], qa[8 * kQKStride], qa[4], qa[8 * kQKStride + 4]);
    }
  }

  for (int j = tile0; j < tile1; ++j) {
    if (j > tile0) {
      issue_tile(j);
      cp_commit();
    }
    cp_wait<0>();                      // tile j
    __syncthreads();
    float y_lo[NP8][4] = {}, y_hi[NP8][4] = {};   // y of each block
    if (carry) {                       // q H_in
#pragma unroll
      for (int n8 = 0; n8 < kNT; n8 += 8) {
#pragma unroll
        for (int p4 = 0; p4 < NP8; p4 += 4) {
          Tf32 b0[4], b1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            b0[i] = b_entry<false>(hs, HS, n8 + t, 8 * (p4 + i) + g);
            b1[i] = b_entry<false>(hs, HS, n8 + t + 4, 8 * (p4 + i) + g);
          }
          mma3_blocks(jt_lo > 0, y_lo + p4, qf[0][n8 / 8], jt_hi > 0,
                      y_hi + p4, qf[1][n8 / 8], b0, b1);
        }
      }
      // Rows g and g + 8 of each block times exp(clip(cum)).
      const float e[4] = {ei[r_lo + g], ei[r_lo + g + 8], ei[r_hi + g],
                          ei[r_hi + g + 8]};
      scale_rows(y_lo, y_hi, e);
    }
    for (int j4 = 0; j4 < jt_end; j4 += 4) {
      const bool do_lo = j4 < jt_lo, do_hi = j4 < jt_hi;
      // q k^T, column tiles j4..j4 + 3 (past a block's end: masked below).
      float s_lo[4][4] = {}, s_hi[4][4] = {};
#pragma unroll
      for (int n8 = 0; n8 < kNT; n8 += 8) {
        Tf32 b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] = b_entry<true>(ks, KS, 8 * (j4 + i) + g, n8 + t);
          b1[i] = b_entry<true>(ks, KS, 8 * (j4 + i) + g, n8 + t + 4);
        }
        mma3_blocks(do_lo, s_lo, qf[0][n8 / 8], do_hi, s_hi, qf[1][n8 / 8],
                    b0, b1);
      }
      // o W: lane (g, t) holds columns 2t, 2t + 1 of rows g, g + 8.
      // W = clip_weight(er_i ec_j) where the chunk factors, else
      // exp(clip(cum_i - cum_j + li_j)) in the reference's order; 0 above
      // the diagonal and outside the chunk.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ja = 8 * (j4 + i) + 2 * t, jb = ja + 1;
        const float eca = ec[ja], ecb = ec[jb];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? do_hi : do_lo)) continue;
          float(&sb)[4][4] = h ? s_hi : s_lo;
          const int ra = (h ? r_hi : r_lo) + g, rc = ra + 8;
          const bool in_a = ra < L, in_c = rc < L;
          if (factored) {
            const float era = er[ra], erc = er[rc];
            sb[i][0] *= ja <= ra && in_a ? clip_weight(era * eca) : 0.0f;
            sb[i][1] *= jb <= ra && in_a ? clip_weight(era * ecb) : 0.0f;
            sb[i][2] *= ja <= rc && in_c ? clip_weight(erc * eca) : 0.0f;
            sb[i][3] *= jb <= rc && in_c ? clip_weight(erc * ecb) : 0.0f;
          } else {
            const float ca = cum[ja], cb = cum[jb];
            const float la = lis[ja], lb = lis[jb];
            const float cra = cum[ra], crc = cum[rc];
            sb[i][0] *= ja <= ra && in_a ? clipped_exp(cra - ca + la) : 0.0f;
            sb[i][1] *= jb <= ra && in_a ? clipped_exp(cra - cb + lb) : 0.0f;
            sb[i][2] *= ja <= rc && in_c ? clipped_exp(crc - ca + la) : 0.0f;
            sb[i][3] *= jb <= rc && in_c ? clipped_exp(crc - cb + lb) : 0.0f;
          }
        }
      }
      // (q k^T o W) v: the weighted accumulator is the A fragment whose k
      // index t is column 2t and t + 4 is 2t + 1; the rows of v follow.
      // Column tiles past a block's causal end are all zero and skipped.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ja = 8 * (j4 + i) + 2 * t;
        const FragA a_lo =
            frag_a(s_lo[i][0], s_lo[i][2], s_lo[i][1], s_lo[i][3]);
        const FragA a_hi =
            frag_a(s_hi[i][0], s_hi[i][2], s_hi[i][1], s_hi[i][3]);
#pragma unroll
        for (int p4 = 0; p4 < NP8; p4 += 4) {
          Tf32 b0[4], b1[4];
#pragma unroll
          for (int pt = 0; pt < 4; ++pt) {
            b0[pt] = b_entry<false>(vs, VS, ja, 8 * (p4 + pt) + g);
            b1[pt] = b_entry<false>(vs, VS, ja + 1, 8 * (p4 + pt) + g);
          }
          mma3_blocks(j4 + i < jt_lo, y_lo + p4, a_lo, j4 + i < jt_hi,
                      y_hi + p4, a_hi, b0, b1);
        }
      }
    }
    const int p0 = j * kNarrowPT;
    T* yb = y + row0 * P + p0;
    const bool even = (P & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float(&yy)[NP8][4] = h ? y_hi : y_lo;
      const int ra = (h ? r_hi : r_lo) + g, rc = ra + 8;
#pragma unroll
      for (int pt = 0; pt < NP8; ++pt) {
        const int col = 8 * pt + 2 * t;
        if (ra < L)
          store_pair(yb + (size_t)ra * P + col, yy[pt][0], yy[pt][1],
                     P - p0 - col, even);
        if (rc < L)
          store_pair(yb + (size_t)rc * P + col, yy[pt][2], yy[pt][3],
                     P - p0 - col, even);
      }
    }
    __syncthreads();                   // v and H are free for the next tile
  }
}

// --- bfloat16: the three stages on bfloat16 tensor cores -------------------
//
// The bfloat16 path keeps q, k and v bfloat16 in shared memory (half the
// float32 tiles' bytes), copies them there by cp.async (16 bytes where a
// row's stride and base allow, 4 where they are 4-byte aligned; a row of
// P = 257 is 2-byte aligned only and takes plain loads, still stored as
// bfloat16), and loads every fragment from there with ldmatrix, whose rows
// (strides of 16 mod 128 bytes) fall on eight distinct 16-byte bank groups.
// The two products whose operands are bfloat16 in the reference, q k^T and
// (q k^T o W) rounded to bfloat16 times v, run on mma.sync m16n8k16 bf16
// with float32 accumulators: the products are exact and the sums float32,
// as the reference's preferred_element_type=float32. The weighted q k^T
// never goes to device memory: two adjacent n8 accumulator tiles, rounded
// to nearest even as they are packed, are the A fragment of one k16 step
// (lane (g, t) holds columns 2t, 2t + 1 of rows g and g + 8 of each). The
// two products that the reference takes in float32, q o exp(cum) times
// H_in and the state update (k o wj)^T v, keep the 3xTF32 split with
// fragments widened from bfloat16 in registers; q and v are exact in tf32,
// so each takes two passes. There the MMA's k index t stands for entry 2t
// of its eight and t + 4 for 2t + 1, so that one 32-bit register of a
// bfloat16 fragment (ldmatrix's, or q's A fragment) holds both.
//
// Why mma.sync and not wgmma: at hymba-1.5B's SSD width the output stage
// moves 266 MB (79 us at 3.35 TB/s) against 3.8 G bfloat16 multiply-adds
// (about 12 us at two thirds of the dense rate) and 0.81 G in 3xTF32, so it
// is bound by bytes once the float32 widening and the tf32 passes of the
// bfloat16 products are gone; wgmma would need 64-row warpgroup tiles and
// K-major tf32 operands for the float32 products.

// How a bfloat16 matrix's rows are copied into shared memory.
enum BfCopy { kCopy16 = 0, kCopy4 = 1, kPlain = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// rows x cols bfloat16 of a row-major global matrix (row stride gs; rows_in
// x cols_in of them exist) into shared memory at row stride ss, zeros
// elsewhere; cols, ss and the tile's first column multiples of 8. kCopy16:
// a 16-byte cp.async a group of 8 (gs a multiple of 8, the base on 16
// bytes); kCopy4: a 4-byte one a pair (gs even, the base on 4 bytes);
// kPlain: 2-byte loads, four groups of 8 of a thread in flight before its
// 16-byte stores, visible after the barrier that follows.
__device__ __forceinline__ void load_bf(bf16* dst, int ss, const bf16* src,
                                       size_t gs, int rows, int cols,
                                       int rows_in, int cols_in, int mode,
                                       int tid, int nthreads) {
  if (mode == kCopy16) {
    const int cg = cols / 8;
    for (int e = tid; e < rows * cg; e += nthreads) {
      const int r = e / cg, c = (e - r * cg) * 8;
      const bool in = r < rows_in && c < cols_in;
      cp_async16(dst + r * ss + c, in ? src + r * gs + c : src, in ? 16 : 0);
    }
  } else if (mode == kCopy4) {
    const int cg = cols / 2;
    for (int e = tid; e < rows * cg; e += nthreads) {
      const int r = e / cg, c = (e - r * cg) * 2;
      const bool in = r < rows_in && c < cols_in;
      cp_async4(dst + r * ss + c, in ? src + r * gs + c : src, in ? 4 : 0);
    }
  } else {
    constexpr int kLoads = 4;
    const int cg = cols / 8, groups = rows * cg;
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(src);
    for (int e0 = tid; e0 < groups; e0 += kLoads * nthreads) {
      uint32_t w[kLoads][4];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nthreads, r = e / cg, c = (e - r * cg) * 8;
        const int n =
            e < groups && r < rows_in ? min(8, max(0, cols_in - c)) : 0;
        const uint16_t* row = bits + (n ? r * gs + c : 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[u][i] = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < n) w[u][i >> 1] |= (uint32_t)row[i] << (16 * (i & 1));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * nthreads, r = e / cg, c = (e - r * cg) * 8;
        if (e < groups)
          *reinterpret_cast<uint4*>(dst + r * ss + c) =
              make_uint4(w[u][0], w[u][1], w[u][2], w[u][3]);
      }
    }
  }
}

// Four 8 x 8 bfloat16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8: register i of lane (g, t) holds
// matrix i's (g, 2t) and (g, 2t + 1), or with .trans its (2t, g) and
// (2t + 1, g), the lower column or row in the low half.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A B with A (16 x 16) and B (16 x 8) bfloat16: a[0] (g, 2t..2t+1),
// a[1] (g+8, 2t..), a[2] (g, 2t+8..), a[3] (g+8, 2t+8..); b0 rows 2t, 2t+1
// and b1 rows 2t+8, 2t+9 of column g.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bfloat16 to nearest even, lo in the low
// half: the reference's (q k^T o W).astype(v.dtype).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The bfloat16 halves of a register as tf32 operands (exact).
__device__ __forceinline__ uint32_t bf_lo(uint32_t x) { return x << 16; }
__device__ __forceinline__ uint32_t bf_hi(uint32_t x) {
  return x & 0xffff0000u;
}

// The tf32 A fragment of q for k step s (q's entries 8s..8s+7, the MMA's
// k index t standing for 8s + 2t and t + 4 for 8s + 2t + 1) from q's
// bfloat16 A fragment (qa[2s] row g, qa[2s + 1] row g + 8): exact, so its
// small parts are 0 and unused (AX).
__device__ __forceinline__ FragA frag_q(const uint32_t (&qa)[4], int s) {
  const uint32_t r0 = qa[2 * s], r1 = qa[2 * s + 1];
  return FragA{{Tf32{bf_lo(r0), 0u}, Tf32{bf_lo(r1), 0u},
                Tf32{bf_hi(r0), 0u}, Tf32{bf_hi(r1), 0u}}};
}

// B fragments of H_in (float32 [kNT][HS] in shared memory) for k step s,
// columns 8 (p + i) + g, i < M: rows 8s + 2t (b0) and 8s + 2t + 1 (b1),
// split.
template <int M>
__device__ __forceinline__ void frag_h(const float* h, int hs, int s, int p,
                                       int g, int t, Tf32 (&b0)[M],
                                       Tf32 (&b1)[M]) {
  const float* r = h + (8 * s + 2 * t) * hs + 8 * p + g;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    b0[i] = split(r[8 * i]);
    b1[i] = split(r[8 * i + hs]);
  }
}

// A warp's 16 x 8 NP accumulator tile of y (rows r0 + g and r0 + g + 8,
// columns 8 pt + 2t, + 1), rounded to bfloat16, into a shared tile of row
// stride ss (ss / 2 = 4 mod 8 words: the 32 lanes' stores on 32 banks).
template <int NP>
__device__ __forceinline__ void stage_y(bf16* tile, int ss,
                                        const float (*acc)[4], int r0, int g,
                                        int t) {
  uint32_t* row0 = reinterpret_cast<uint32_t*>(tile + (r0 + g) * ss);
  uint32_t* row8 = reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * ss);
#pragma unroll
  for (int pt = 0; pt < NP; ++pt) {
    row0[4 * pt + t] = pack_bf16(acc[pt][0], acc[pt][1]);
    row8[4 * pt + t] = pack_bf16(acc[pt][2], acc[pt][3]);
  }
}

// rows x cols (a multiple of 8) bfloat16 of a shared tile (row stride ss)
// into a row-major global matrix (row stride gs), the rows_in x cols_in of
// it that exist: a 16-byte store a group of 8 where `vec` (gs a multiple of
// 8, the base and the tile's first column on 16 bytes), else 2-byte
// stores. A warp's 16-byte stores cover whole rows of the tile, so y leaves
// in whole 32-byte sectors.
__device__ __forceinline__ void store_bf(bf16* dst, size_t gs,
                                         const bf16* src, int ss, int rows,
                                         int cols, int rows_in, int cols_in,
                                         bool vec, int tid, int nthreads) {
  const int cg = cols / 8;
  for (int e = tid; e < rows * cg; e += nthreads) {
    const int r = e / cg, c = (e - r * cg) * 8;
    if (r >= rows_in || c >= cols_in) continue;
    const bf16* from = src + r * ss + c;
    bf16* to = dst + r * gs + c;
    if (vec) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      const int n = min(8, cols_in - c);
      for (int i = 0; i < n; ++i) to[i] = from[i];
    }
  }
}

// Stage 1 in bfloat16: the float32 kernel's tiles and slabs of 32 rows in
// copy groups, k and v bfloat16. A 16-row step of the chunk is one
// ldmatrix.trans of k (A = (k o wj)^T: rows n g, g + 8 of the warp's 16,
// both k steps) and one of v per two column tiles (B), then two k steps of
// (k o wj) split (not exact) times v (exact): two passes.
template <int WM, int NTW>
struct StateTileBf {
  static constexpr int NT = 16 * WM, PT = 4 / WM * 8 * NTW;
  static constexpr int KS = NT + 8, VS = PT + 8;      // bfloat16 rows
  static_assert(NTW % 2 == 0, "v by ldmatrix: two column tiles a load");
  static size_t smem_bytes(int lp) {
    return 2 * (size_t)lp * (KS + VS) + 3 * kMaxL * sizeof(float);
  }
};

template <int WM, int NTW>
__global__ void __launch_bounds__(kStateThreads) gla_chunk_state_bf16(
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ li,
    float* __restrict__ states, float* __restrict__ tot, int S, int N, int P,
    int L, int mode_k, int mode_v) {
  using Tile = StateTileBf<WM, NTW>;
  constexpr int NT = Tile::NT, PT = Tile::PT, KS = Tile::KS, VS = Tile::VS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int tiles_p = (P + PT - 1) / PT;
  const int n0 = (blockIdx.x / tiles_p) * NT, p0 = (blockIdx.x % tiles_p) * PT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);
  bf16* ks = reinterpret_cast<bf16*>(smem);           // [lp][KS]
  bf16* vs = ks + (size_t)lp * KS;                    // [lp][VS]
  float* cum = reinterpret_cast<float*>(vs + (size_t)lp * VS);
  float* lis = cum + kMaxL;
  float* wj = lis + kMaxL;

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  const int slabs = lp / 32;
  for (int s = 0; s < slabs; ++s) {
    const int r0 = 32 * s, rows_in = max(0, min(32, L - r0));
    load_bf(ks + r0 * KS, KS, k + (row0 + r0) * N + n0, N, 32, NT, rows_in,
            N - n0, mode_k, tid, kStateThreads);
    load_bf(vs + r0 * VS, VS, v + (row0 + r0) * P + p0, P, 32, PT, rows_in,
            P - p0, mode_v, tid, kStateThreads);
    cp_commit();
  }
  gate_scan(gt, cum, lis, tid);
  const float total = cum[L - 1];
  for (int j = tid; j < lp; j += kStateThreads)
    wj[j] = j < L ? clipped_exp(total - cum[j] + lis[j]) : 0.0f;
  if (blockIdx.x == 0 && tid == 0) tot[(size_t)bh * nc + c] = total;

  const int wm = warp % WM, wn = warp / WM;
  const int rn = 16 * wm, cp0 = 8 * NTW * wn;
  const bool active = n0 + rn < N && p0 + cp0 < P;
  // ldmatrix rows: k's (A, .trans) rows j0 + lane % 8 (+ 8 for lanes
  // 16..31), columns rn (+ 8 for lanes 8..15 and 24..31); v's (B, .trans)
  // rows j0 + lane % 16, columns (+ 8 for lanes 16..31).
  const int ka_row = (lane & 7) + ((lane >> 4) << 3);
  const int ka_col = rn + (((lane >> 3) & 1) << 3);
  const int vb_row = lane & 15, vb_col = cp0 + ((lane >> 4) << 3);
  float acc[NTW][4] = {};
  for (int s = 0; s < slabs; ++s) {
    cp_wait_upto(slabs - 1 - s);
    __syncthreads();                  // this slab's copies and wj visible
    if (!active) continue;
    const int jend = min(32 * s + 32, round_up(L, 16));
    for (int j0 = 32 * s; j0 < jend; j0 += 16) {
      uint32_t ka[4], vb[NTW / 2][4];
      ldsm_x4_t(ka, ks + (j0 + ka_row) * KS + ka_col);
#pragma unroll
      for (int pp = 0; pp < NTW / 2; ++pp)
        ldsm_x4_t(vb[pp], vs + (j0 + vb_row) * VS + vb_col + 16 * pp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // rows j0 + 8h .. j0 + 8h + 7
        // A[n][j] = k[j][n] wj[j]: ka[2h] rows n = g, ka[2h + 1] n = g + 8;
        // low halves j = j0 + 8h + 2t (k index t), high 2t + 1 (t + 4).
        const float w0 = wj[j0 + 8 * h + 2 * t];
        const float w1 = wj[j0 + 8 * h + 2 * t + 1];
        const uint32_t x = ka[2 * h], y = ka[2 * h + 1];
        const FragA a = frag_a(__uint_as_float(bf_lo(x)) * w0,
                               __uint_as_float(bf_lo(y)) * w0,
                               __uint_as_float(bf_hi(x)) * w1,
                               __uint_as_float(bf_hi(y)) * w1);
        Tf32 b0[NTW], b1[NTW];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const uint32_t r = vb[nt / 2][2 * (nt & 1) + h];
          b0[nt] = Tf32{bf_lo(r), 0u};
          b1[nt] = Tf32{bf_hi(r), 0u};
        }
        mma3<NTW, false, true>(acc, a, b0, b1);   // (k o wj) v
      }
    }
  }
  if (!active) return;
  float* out = states + (((size_t)bh * nc + c) * N + n0 + rn) * P + p0 + cp0;
  const bool even = (P & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = 8 * nt + 2 * t, left = P - p0 - cp0 - col;
    if (n0 + rn + g < N)
      store_pair(out + (size_t)g * P + col, acc[nt][0], acc[nt][1], left,
                 even);
    if (n0 + rn + g + 8 < N)
      store_pair(out + (size_t)(g + 8) * P + col, acc[nt][2], acc[nt][3],
                 left, even);
  }
}

// The weights of two adjacent n8 tiles of q k^T (s[e], columns j0 + 8e +
// 2t, + 1 of rows ra = r0 + g and ra + 8), rounded to bfloat16 as they are
// packed into the A fragment of the k16 step at j0. W as the float32
// kernels weigh (`factored`: clip_weight of the row and column factors er,
// ec; else each entry's clipped exp in the reference's order), 0 above the
// diagonal and outside the chunk; `full` (a step left of the row block's
// diagonal, every row inside the chunk) needs no mask.
__device__ __forceinline__ void weigh_pack(float (&s)[2][4], uint32_t (&a)[4],
                                           int j0, int ra, int t, int l,
                                           bool full, bool factored,
                                           const float* cum, const float* lis,
                                           const float* er, const float* ec) {
  const int rc = ra + 8;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ja = j0 + 8 * e + 2 * t, jb = ja + 1;
    float w[4];
    if (factored) {
      const float eca = ec[ja], ecb = ec[jb], era = er[ra], erc = er[rc];
      w[0] = clip_weight(era * eca);
      w[1] = clip_weight(era * ecb);
      w[2] = clip_weight(erc * eca);
      w[3] = clip_weight(erc * ecb);
    } else {
      const float ca = cum[ja], cb = cum[jb], la = lis[ja], lb = lis[jb];
      const float cra = cum[ra], crc = cum[rc];
      w[0] = clipped_exp(cra - ca + la);
      w[1] = clipped_exp(cra - cb + lb);
      w[2] = clipped_exp(crc - ca + la);
      w[3] = clipped_exp(crc - cb + lb);
    }
    if (!full) {
      const bool in_a = ra < l, in_c = rc < l;
      w[0] = ja <= ra && in_a ? w[0] : 0.0f;
      w[1] = jb <= ra && in_a ? w[1] : 0.0f;
      w[2] = ja <= rc && in_c ? w[2] : 0.0f;
      w[3] = jb <= rc && in_c ? w[3] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[e][i] *= w[i];
  }
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// Stage 3 in bfloat16 for N <= kNT (hymba's SSD branch): a CTA a chunk,
// walking `per` P-tiles of kNarrowPT columns with v and H_in
// double-buffered: the first two tiles are in flight from the start, and
// tile j + 2 goes out as tile j leaves.
// Eight warps, one row block of 16 each: rb = w for w < 4 and 11 - w
// above, so that the two warps of a scheduler (w, w + 4) hold blocks rb
// and 7 - rb, equal causal work at L = 128. A warp makes its block's q k^T
// o W once for all the P-tiles (a k16 step of the chunk: one ldmatrix of
// k, two MMAs, the weights of weigh_pack), while the first two P-tiles
// land, and keeps it packed as the A fragments of (q k^T o W) v in shared
// memory (a lane's 16 bytes a step, so that the registers go to the warp's
// 16 x 64 tile of y); a step of a P-tile is then one 16-byte load of the
// fragment, one ldmatrix.trans of v per two column tiles of y and its
// MMAs. y leaves through v's buffer in whole rows (stage_y, store_bf).
// Shared memory in bytes: q and k [Lp][QS], v [2][Lp][VS] (bfloat16), the
// fragments [8][8][32] (16 bytes each), H [2][kNT][HS], cum, li,
// exp(clip(cum)), er and ec [kMaxL] (float32): 92 KB at L = 128, two CTAs
// an SM.
constexpr int kNarrowBfThreads = 256;

struct NarrowTileBf {
  static constexpr int QS = kNT + 8;              // q, k: 48-byte rows
  static constexpr int VS = kNarrowPT + 8;        // v: 144-byte rows
  static constexpr int HS = kNarrowPT + 4;        // H: B rows 2t, col g
  // (q k^T o W) as A fragments: [warp][k16 step][lane], 16 bytes each
  static constexpr int PA = kNarrowBfThreads / 32 * (kMaxL / 16) * 32;
  static size_t smem_bytes(int lp) {
    return 2 * ((size_t)lp * 2 * QS + 2 * (size_t)lp * VS) + 16 * PA +
           sizeof(float) * (2 * kNT * HS + 5 * kMaxL);
  }
};

__global__ void __launch_bounds__(kNarrowBfThreads, 2)
    gla_chunk_output_narrow_bf16(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const float* __restrict__ ld,
        const float* __restrict__ li, const float* __restrict__ h_in,
        bf16* __restrict__ y, int S, int N, int P, int L, int per,
        int mode_qk, int mode_v, int vec_h, int vec_y) {
  constexpr int QS = NarrowTileBf::QS, VS = NarrowTileBf::VS;
  constexpr int HS = NarrowTileBf::HS, NP8 = kNarrowPT / 8;
  constexpr int NT = kNarrowBfThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int tile0 = blockIdx.x * per;
  const int tile1 = min(tile0 + per, (P + kNarrowPT - 1) / kNarrowPT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [lp][QS]
  bf16* ks = qs + (size_t)lp * QS;                 // [lp][QS]
  bf16* vs = ks + (size_t)lp * QS;                 // [2][lp][VS]
  uint4* paf = reinterpret_cast<uint4*>(vs + 2 * (size_t)lp * VS);
  float* hs = reinterpret_cast<float*>(paf + NarrowTileBf::PA);
  float* cum = hs + 2 * kNT * HS;                  // H: [2][kNT][HS]
  float* lis = cum + kMaxL;
  float* ei = lis + kMaxL;
  float* er = ei + kMaxL;                          // row factors
  float* ec = er + kMaxL;                          // column factors

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const bool carry = c > 0;            // H_in(0) = 0: no q H term
  const float* hc = h_in + ((size_t)bh * nc + c) * N * P;
  // v and H_in's columns of P-tile j into buffer (j - tile0) % 2.
  auto issue_tile = [&](int j) {
    const int p0 = j * kNarrowPT, b = (j - tile0) & 1;
    load_bf(vs + b * (size_t)lp * VS, VS, v + row0 * P + p0, P, lp,
            kNarrowPT, L, P - p0, mode_v, tid, NT);
    if (carry)
      load_tile(hs + b * kNT * HS, HS, hc + p0, P, kNT, kNarrowPT, N, P - p0,
                vec_h, tid, NT);
  };
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  // Copy groups: q and k, then the first two P-tiles (the second group
  // empty with one tile), then one a tile after each tile's store, so that
  // the two tiles a buffer holds are in flight under the weights.
  load_bf(qs, QS, q + row0 * N, N, lp, kNT, L, N, mode_qk, tid, NT);
  load_bf(ks, QS, k + row0 * N, N, lp, kNT, L, N, mode_qk, tid, NT);
  cp_commit();
  issue_tile(tile0);
  cp_commit();
  if (tile0 + 1 < tile1) issue_tile(tile0 + 1);
  cp_commit();
  gate_scan(gt, cum, lis, tid);
  float m;
  const bool factored = weights_factor(cum, lis, L, lane, &m);
  for (int i = tid; i < lp; i += NT) {
    ei[i] = i < L ? clipped_exp(cum[i]) : 0.0f;
    er[i] = factored && i < L ? expf(cum[i] - m) : 0.0f;
    ec[i] = factored && i < L ? expf(lis[i] - cum[i] + m) : 0.0f;
  }
  cp_wait<2>();                        // q and k
  __syncthreads();

  // The warp's row block and its k16 steps with causal entries.
  const int rb = warp < 4 ? warp : 11 - warp, r0 = 16 * rb;
  const int steps = r0 < L ? min(rb + 1, round_up(L, 16) / 16) : 0;
  uint32_t qa[4] = {};                 // q's A fragment of q k^T
  if (steps) ldsm_x4(qa, qs + (r0 + (lane & 15)) * QS + ((lane >> 4) << 3));
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) << 3;
  const int vb_row = lane & 15, vb_col = (lane >> 4) << 3;
  const int ra = r0 + g;
  // q k^T o W of the k16 steps st < steps: column tiles 2 st and 2 st + 1
  // (B of tile 2 st + e: kb[2e], kb[2e + 1]), weighted and packed into
  // the warp's A fragments in shared memory (a lane's 16 bytes a step).
  uint4* pw = paf + warp * (kMaxL / 16) * 32 + lane;
  for (int st = 0; st < steps; ++st) {
    uint32_t kb[4], a[4];
    ldsm_x4(kb, ks + (16 * st + kb_row) * QS + kb_col);
    float s2[2][4] = {};
    mma_bf16(s2[0], qa, kb[0], kb[1]);
    mma_bf16(s2[1], qa, kb[2], kb[3]);
    weigh_pack(s2, a, 16 * st, ra, t, L, st < rb && r0 + 16 <= L, factored,
               cum, lis, er, ec);
    pw[32 * st] = make_uint4(a[0], a[1], a[2], a[3]);
  }

  for (int j = tile0; j < tile1; ++j) {
    cp_wait<1>();                      // tile j (tile j + 1 may be in flight)
    __syncthreads();
    const int b = (j - tile0) & 1;
    bf16* vt = vs + b * (size_t)lp * VS;
    const float* ht = hs + b * kNT * HS;
    float yv[NP8][4] = {};
    if (steps) {
      if (carry) {                     // q H_in, then times exp(clip(cum))
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const FragA a = frag_q(qa, s);
#pragma unroll
          for (int p2 = 0; p2 < NP8; p2 += 2) {
            Tf32 b0[2], b1[2];
            frag_h(ht, HS, s, p2, g, t, b0, b1);
            mma3<2, true>(yv + p2, a, b0, b1);
          }
        }
        const float e0 = ei[ra], e1 = ei[ra + 8];
#pragma unroll
        for (int pt = 0; pt < NP8; ++pt) {
          yv[pt][0] *= e0;
          yv[pt][1] *= e0;
          yv[pt][2] *= e1;
          yv[pt][3] *= e1;
        }
      }
      for (int st = 0; st < steps; ++st) {   // (q k^T o W) v
        const uint4 f = pw[32 * st];
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int pp = 0; pp < NP8 / 2; ++pp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vt + (16 * st + vb_row) * VS + vb_col + 16 * pp);
          mma_bf16(yv[2 * pp], a, vb[0], vb[1]);
          mma_bf16(yv[2 * pp + 1], a, vb[2], vb[3]);
        }
      }
    }
    // y through v's buffer, which every warp is done with, so that it
    // leaves in whole rows of the tile.
    __syncthreads();
    if (steps) stage_y<NP8>(vt, VS, yv, r0, g, t);
    __syncthreads();
    const int p0 = j * kNarrowPT;
    store_bf(y + row0 * P + p0, P, vt, VS, lp, kNarrowPT, L, P - p0, vec_y,
             tid, NT);
    __syncthreads();                   // buffer b is free for tile j + 2
    if (j + 2 < tile1) issue_tile(j + 2);
    cp_commit();                       // (empty past the last tile)
  }
}

// Stage 3 in bfloat16 for N > kNT (xLSTM's N = 256): the float32 wide
// kernel's CTA (eight warps, 16 rows of the chunk each, rb as there, kPT
// columns of P) in two streams over N, so that no warp holds q k^T and
// q H at once: first q and k tiles of kWT columns of N (q k^T in 16 n8
// tiles, four k16 steps a tile), then, once q k^T is weighted and packed
// into eight bfloat16 A fragments (32 registers), q and H tiles (q H in
// 3xTF32, eight k8 steps a tile). A warp holds 64 accumulators of q k^T,
// which at two CTAs an SM (128 registers) spilled, so the kernel takes
// one CTA an SM and keeps its memory busy with depth instead: a ring of
// kWideStages tile buffers, two tiles in flight ahead of the one in use.
// Shared memory in bytes: q [S][Lp][QS] and k or H [S][.] (bfloat16 k
// [Lp][QS], float32 H [kWT][HS]), v [Lp][VS] (bfloat16, loaded with the
// first tile), cum, li and exp(clip(cum)) [kMaxL]: 128 KB at L = 128.
constexpr int kWT = 64;                  // columns of N in a q/k/H tile
constexpr int kWideStages = 3;

struct OutTileBf {
  static constexpr int QS = kWT + 8;     // q, k: 144-byte rows
  static constexpr int VS = kPT + 8;     // v: 144-byte rows
  static constexpr int HS = kPT + 4;     // H: B rows 2t, col g
  // bytes of a stage's k-or-H buffer
  static __host__ __device__ size_t kh_bytes(int lp) {
    const size_t kb = 2 * (size_t)lp * QS, hb = 4 * (size_t)kWT * HS;
    return kb > hb ? kb : hb;
  }
  static size_t smem_bytes(int lp) {
    return kWideStages * (2 * (size_t)lp * QS + kh_bytes(lp)) +
           2 * (size_t)lp * VS + sizeof(float) * 3 * kMaxL;
  }
};

__global__ void __launch_bounds__(kOutThreads, 1) gla_chunk_output_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ li, const float* __restrict__ h_in,
    bf16* __restrict__ y, int S, int N, int P, int L, int mode_qk,
    int mode_v, int vec_h, int vec_y) {
  constexpr int QS = OutTileBf::QS, VS = OutTileBf::VS, HS = OutTileBf::HS;
  constexpr int NP8 = kPT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = S / L, c = blockIdx.y, bh = blockIdx.z;
  const int p0 = blockIdx.x * kPT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round_up(L, 32);
  const size_t q_step = (size_t)lp * QS, kh_step = OutTileBf::kh_bytes(lp);
  bf16* qs = reinterpret_cast<bf16*>(smem);           // [stage][lp][QS]
  unsigned char* khs = smem + 2 * kWideStages * q_step;
  bf16* vs = reinterpret_cast<bf16*>(khs + kWideStages * kh_step);
  float* cum = reinterpret_cast<float*>(vs + (size_t)lp * VS);
  float* lis = cum + kMaxL;
  float* ei = lis + kMaxL;
  auto q_tile = [&](int it) { return qs + (it % kWideStages) * q_step; };
  auto k_tile = [&](int it) {
    return reinterpret_cast<bf16*>(khs + (it % kWideStages) * kh_step);
  };
  auto h_tile = [&](int it) {
    return reinterpret_cast<float*>(khs + (it % kWideStages) * kh_step);
  };

  const size_t row0 = (size_t)bh * S + (size_t)c * L;
  const bool carry = c > 0;            // H_in(0) = 0: no q H term
  const float* hb = h_in + ((size_t)bh * nc + c) * N * P + p0;
  const int tiles = (N + kWT - 1) / kWT;
  const int passes = carry ? 2 * tiles : tiles;
  // Tile `it` of the two streams into its stage: q with k (it < tiles)
  // or with H (after), columns n0.. of N; nothing past the last.
  auto issue = [&](int it) {
    if (it >= passes) return;
    const int n0 = (it % tiles) * kWT;
    load_bf(q_tile(it), QS, q + row0 * N + n0, N, lp, kWT, L, N - n0,
            mode_qk, tid, kOutThreads);
    if (it < tiles)
      load_bf(k_tile(it), QS, k + row0 * N + n0, N, lp, kWT, L, N - n0,
              mode_qk, tid, kOutThreads);
    else
      load_tile(h_tile(it), HS, hb + (size_t)n0 * P, P, kWT, kPT, N - n0,
                P - p0, vec_h, tid, kOutThreads);
  };
  // Issues tile it + 2, waits for tile it (every copy group but the two
  // newest), and makes it visible.
  auto next = [&](int it) {
    issue(it + 2);
    cp_commit();
    cp_wait<2>();
    __syncthreads();
  };
  const Gates gt = gate_load(ld + row0, li + row0, L, tid);
  issue(0);
  load_bf(vs, VS, v + row0 * P + p0, P, lp, kPT, L, P - p0, mode_v, tid,
          kOutThreads);
  cp_commit();
  issue(1);
  cp_commit();
  gate_scan(gt, cum, lis, tid);
  for (int i = tid; i < lp; i += kOutThreads)
    ei[i] = i < L ? clipped_exp(cum[i]) : 0.0f;

  const int rb = warp < 4 ? warp : 11 - warp;
  const int r0 = 16 * rb;
  const int steps = r0 < L ? min(rb + 1, round_up(L, 16) / 16) : 0;
  const int qa_row = r0 + (lane & 15), qa_col = (lane >> 4) << 3;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) << 3;
  const int i0 = r0 + g, i1 = i0 + 8;
  uint32_t pa[8][4];                       // (q k^T o W), bfloat16 A frags
  {
    float acc_a[8][2][4] = {};             // (q k^T) rows r0.., cols 16 st..
    for (int it = 0; it < tiles; ++it) {
      next(it);
      if (steps) {
        const bf16* qt = q_tile(it);
        const bf16* kt = k_tile(it);
#pragma unroll
        for (int n16 = 0; n16 < kWT / 16; ++n16) {
          uint32_t qa[4];
          ldsm_x4(qa, qt + qa_row * QS + 16 * n16 + qa_col);
#pragma unroll
          for (int st = 0; st < 8; ++st) {
            if (st < steps) {
              uint32_t kb[4];
              ldsm_x4(kb, kt + (16 * st + kb_row) * QS + 16 * n16 + kb_col);
              mma_bf16(acc_a[st][0], qa, kb[0], kb[1]);
              mma_bf16(acc_a[st][1], qa, kb[2], kb[3]);
            }
          }
        }
      }
      __syncthreads();                     // the stage is free for it + 3
    }
    // o W in the reference's order (each entry's clipped exp), packed to
    // bfloat16 a step at a time.
#pragma unroll
    for (int st = 0; st < 8; ++st)
      if (st < steps)
        weigh_pack(acc_a[st], pa[st], 16 * st, i0, t, L, false, false, cum,
                   lis, nullptr, nullptr);
  }
  float acc_y[NP8][4] = {};                // (q H)   rows r0.., cols 8 pt..
  for (int it = tiles; it < passes; ++it) {
    next(it);
    if (steps) {
      const bf16* qt = q_tile(it);
      const float* ht = h_tile(it);
#pragma unroll
      for (int n16 = 0; n16 < kWT / 16; ++n16) {
        uint32_t qa[4];
        ldsm_x4(qa, qt + qa_row * QS + 16 * n16 + qa_col);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const FragA a = frag_q(qa, s);
#pragma unroll
          for (int p2 = 0; p2 < NP8; p2 += 2) {
            Tf32 b0[2], b1[2];
            frag_h(ht, HS, 2 * n16 + s, p2, g, t, b0, b1);
            mma3<2, true>(acc_y + p2, a, b0, b1);
          }
        }
      }
    }
    __syncthreads();                       // the stage is free for it + 3
  }
  cp_wait<0>();
  __syncthreads();                         // v visible

  // y = exp(cum) o (q H) + (q k^T o W) v.
  const float e0 = ei[i0], e1 = ei[i1];
#pragma unroll
  for (int pt = 0; pt < NP8; ++pt) {
    acc_y[pt][0] *= e0;
    acc_y[pt][1] *= e0;
    acc_y[pt][2] *= e1;
    acc_y[pt][3] *= e1;
  }
  const int vb_row = lane & 15, vb_col = (lane >> 4) << 3;
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    if (st < steps) {
#pragma unroll
      for (int pp = 0; pp < NP8 / 2; ++pp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (16 * st + vb_row) * VS + vb_col + 16 * pp);
        mma_bf16(acc_y[2 * pp], pa[st], vb[0], vb[1]);
        mma_bf16(acc_y[2 * pp + 1], pa[st], vb[2], vb[3]);
      }
    }
  }
  // y through v's buffer, as the narrow kernel stores it.
  __syncthreads();
  if (steps) stage_y<NP8>(vs, VS, acc_y, r0, g, t);
  __syncthreads();
  store_bf(y + row0 * P + p0, P, vs, VS, lp, kPT, L, P - p0, vec_y, tid,
           kOutThreads);
}

// --- launches -----------------------------------------------------------------

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Lets a kernel take `smem` bytes of dynamic shared memory, with the SM's
// largest shared-memory carveout, so that as many CTAs fit as the bytes
// allow.
cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_shape(int bh, int s, int n, int p, int l) {
  return bh <= 0 || s <= 0 || n <= 0 || p <= 0 || l <= 0 || l > kMaxL ||
         s % l || s / l > 65535 || bh > 65535;
}

template <int WM, int NTW>
int launch_state(const float* k, const float* v, const float* ld,
                 const float* li, float* states, float* tot, int bh, int s,
                 int n, int p, int l, cudaStream_t stream) {
  using Tile = StateTile<WM, NTW>;
  const int nc = s / l;
  if (nc < 2) return (int)cudaSuccess;   // the last chunk's state is unused
  const int lp = (l + 31) / 32 * 32;
  const size_t smem = Tile::smem_floats(lp) * sizeof(float);
  cudaError_t err =
      opt_in((const void*)gla_chunk_state<float, WM, NTW>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + Tile::NT - 1) / Tile::NT) *
                             ((p + Tile::PT - 1) / Tile::PT)),
                  (unsigned)(nc - 1), (unsigned)bh);
  gla_chunk_state<float, WM, NTW><<<grid, kStateThreads, smem, stream>>>(
      k, v, ld, li, states, tot, s, n, p, l,
      n % 4 == 0 && aligned16(k), p % 4 == 0 && aligned16(v));
  return (int)cudaGetLastError();
}

// CTA tiles of S_c: 16 x 64 (N <= 16), 32 x 64 (N <= 32), else 64 x 32.
int chunk_state(const float* k, const float* v, const float* ld,
                const float* li, float* states, float* tot, int bh, int s,
                int n, int p, int l, cudaStream_t stream) {
  if (n <= 16)
    return launch_state<1, 2>(k, v, ld, li, states, tot, bh, s, n, p, l,
                              stream);
  if (n <= 32)
    return launch_state<2, 4>(k, v, ld, li, states, tot, bh, s, n, p, l,
                              stream);
  return launch_state<4, 4>(k, v, ld, li, states, tot, bh, s, n, p, l,
                            stream);
}

int state_pass(float* states, const float* tot, int bh, int nc, int np,
               cudaStream_t stream) {
  if (bh <= 0 || nc <= 0 || np <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((np + 255) / 256), (unsigned)bh);
  gla_state_pass<<<grid, 256, 0, stream>>>(states, tot, nc, np);
  return (int)cudaGetLastError();
}

// CTAs of a kernel that one SM holds at once with `smem` bytes each.
template <typename K>
int resident(K kernel, int threads, size_t smem) {
  int ctas = 0;
  if (opt_in((const void*)kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return ctas;
}

template <int WM, int NTW>
int state_resident(int l) {
  const size_t lp = (l + 31) / 32 * 32;
  return resident(gla_chunk_state<float, WM, NTW>, kStateThreads,
                  StateTile<WM, NTW>::smem_floats(lp) * sizeof(float));
}

size_t output_smem(int n, int l) {
  const int lp = (l + 31) / 32 * 32;
  return (n <= kNT ? NarrowTile::smem_floats(lp)
                   : OutTile::smem_floats(lp)) * sizeof(float);
}

// P-tiles a narrow CTA walks: all of a chunk's, unless that leaves fewer
// than kNarrowCTAs CTAs to fill the card (three an SM, two waves).
constexpr int kNarrowCTAs = 2 * 3 * 132;

int narrow_per(int bh, int s, int p, int l) {
  const int tiles = (p + kNarrowPT - 1) / kNarrowPT;
  const long chunks = (long)bh * (s / l);
  const int groups =
      (int)std::min<long>(tiles, (kNarrowCTAs + chunks - 1) / chunks);
  return (tiles + groups - 1) / groups;
}

int chunk_output(const float* q, const float* k, const float* v,
                 const float* ld, const float* li, const float* h_in,
                 float* y, int bh, int s, int n, int p, int l,
                 cudaStream_t stream) {
  const size_t smem = output_smem(n, l);
  const int vec_qk = n % 4 == 0 && aligned16(q) && aligned16(k);
  const int vec_vh = p % 4 == 0 && aligned16(v) && aligned16(h_in);
  cudaError_t err;
  if (n <= kNT) {
    err = opt_in((const void*)gla_chunk_output_narrow<float>, smem);
    if (err != cudaSuccess) return (int)err;
    const int per = narrow_per(bh, s, p, l);
    const int tiles = (p + kNarrowPT - 1) / kNarrowPT;
    const dim3 grid((unsigned)((tiles + per - 1) / per), (unsigned)(s / l),
                    (unsigned)bh);
    gla_chunk_output_narrow<float><<<grid, kNarrowThreads, smem, stream>>>(
        q, k, v, ld, li, h_in, y, s, n, p, l, per, vec_qk, vec_vh);
  } else {
    err = opt_in((const void*)gla_chunk_output<float>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((p + kPT - 1) / kPT), (unsigned)(s / l),
                    (unsigned)bh);
    gla_chunk_output<float><<<grid, kOutThreads, smem, stream>>>(
        q, k, v, ld, li, h_in, y, s, n, p, l, vec_qk, vec_vh);
  }
  return (int)cudaGetLastError();
}

int forward(const float* q, const float* k, const float* v,
            const float* ld, const float* li, float* y, float* states,
            float* tot, int bh, int s, int n, int p, int l,
            cudaStream_t st) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  int err = chunk_state(k, v, ld, li, states, tot, bh, s, n, p, l, st);
  if (err) return err;
  err = state_pass(states, tot, bh, s / l, n * p, st);
  if (err) return err;
  return chunk_output(q, k, v, ld, li, states, y, bh, s, n, p, l, st);
}

// How load_bf copies rows of `row` bfloat16 from `base`.
int copy_mode(const void* base, int row) {
  const uintptr_t a = (uintptr_t)base;
  if (row % 8 == 0 && (a & 15) == 0) return kCopy16;
  if (row % 2 == 0 && (a & 3) == 0) return kCopy4;
  return kPlain;
}

template <int WM, int NTW>
int launch_state_bf16(const bf16* k, const bf16* v, const float* ld,
                      const float* li, float* states, float* tot, int bh,
                      int s, int n, int p, int l, cudaStream_t stream) {
  using Tile = StateTileBf<WM, NTW>;
  const int nc = s / l;
  if (nc < 2) return (int)cudaSuccess;   // the last chunk's state is unused
  const size_t smem = Tile::smem_bytes((l + 31) / 32 * 32);
  cudaError_t err = opt_in((const void*)gla_chunk_state_bf16<WM, NTW>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + Tile::NT - 1) / Tile::NT) *
                             ((p + Tile::PT - 1) / Tile::PT)),
                  (unsigned)(nc - 1), (unsigned)bh);
  gla_chunk_state_bf16<WM, NTW><<<grid, kStateThreads, smem, stream>>>(
      k, v, ld, li, states, tot, s, n, p, l, copy_mode(k, n),
      copy_mode(v, p));
  return (int)cudaGetLastError();
}

// The float32 kernel's CTA tiles of S_c.
int chunk_state_bf16(const bf16* k, const bf16* v, const float* ld,
                     const float* li, float* states, float* tot, int bh,
                     int s, int n, int p, int l, cudaStream_t stream) {
  if (n <= 16)
    return launch_state_bf16<1, 2>(k, v, ld, li, states, tot, bh, s, n, p, l,
                                   stream);
  if (n <= 32)
    return launch_state_bf16<2, 4>(k, v, ld, li, states, tot, bh, s, n, p, l,
                                   stream);
  return launch_state_bf16<4, 4>(k, v, ld, li, states, tot, bh, s, n, p, l,
                                 stream);
}

int chunk_output_bf16(const bf16* q, const bf16* k, const bf16* v,
                      const float* ld, const float* li, const float* h_in,
                      bf16* y, int bh, int s, int n, int p, int l,
                      cudaStream_t stream) {
  const int lp = (l + 31) / 32 * 32;
  const int mode_qk = std::max(copy_mode(q, n), copy_mode(k, n));
  const int mode_v = copy_mode(v, p);
  const int vec_h = p % 4 == 0 && aligned16(h_in);
  const int vec_y = p % 8 == 0 && aligned16(y);
  cudaError_t err;
  if (n <= kNT) {
    const size_t smem = NarrowTileBf::smem_bytes(lp);
    err = opt_in((const void*)gla_chunk_output_narrow_bf16, smem);
    if (err != cudaSuccess) return (int)err;
    const int per = narrow_per(bh, s, p, l);
    const int tiles = (p + kNarrowPT - 1) / kNarrowPT;
    const dim3 grid((unsigned)((tiles + per - 1) / per), (unsigned)(s / l),
                    (unsigned)bh);
    gla_chunk_output_narrow_bf16<<<grid, kNarrowBfThreads, smem, stream>>>(
        q, k, v, ld, li, h_in, y, s, n, p, l, per, mode_qk, mode_v, vec_h,
        vec_y);
  } else {
    const size_t smem = OutTileBf::smem_bytes(lp);
    err = opt_in((const void*)gla_chunk_output_bf16, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((p + kPT - 1) / kPT), (unsigned)(s / l),
                    (unsigned)bh);
    gla_chunk_output_bf16<<<grid, kOutThreads, smem, stream>>>(
        q, k, v, ld, li, h_in, y, s, n, p, l, mode_qk, mode_v, vec_h, vec_y);
  }
  return (int)cudaGetLastError();
}

int forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                 const float* ld, const float* li, bf16* y, float* states,
                 float* tot, int bh, int s, int n, int p, int l,
                 cudaStream_t st) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  int err = chunk_state_bf16(k, v, ld, li, states, tot, bh, s, n, p, l, st);
  if (err) return err;
  err = state_pass(states, tot, bh, s / l, n * p, st);
  if (err) return err;
  return chunk_output_bf16(q, k, v, ld, li, states, y, bh, s, n, p, l, st);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: a refused launch is reported here, never run.

// Stage 1: states [bh, s / l, n, p] (all but the last chunk's) and tot
// [bh, s / l] from k [bh, s, n], v [bh, s, p], ld, li [bh, s].
int gla_chunk_state_launch(const float* k, const float* v, const float* ld,
                           const float* li, float* states, float* tot, int bh,
                           int s, int n, int p, int l, void* stream) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  return chunk_state(k, v, ld, li, states, tot, bh, s, n, p, l,
                     (cudaStream_t)stream);
}

// The same from bfloat16 k and v.
int gla_chunk_state_bf16_launch(const bf16* k, const bf16* v, const float* ld,
                                const float* li, float* states, float* tot,
                                int bh, int s, int n, int p, int l,
                                void* stream) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  return chunk_state_bf16(k, v, ld, li, states, tot, bh, s, n, p, l,
                          (cudaStream_t)stream);
}

// Stage 2, in place: states [bh, nc, np] -> H_in.
int gla_state_pass_launch(float* states, const float* tot, int bh, int nc,
                          int np, void* stream) {
  return state_pass(states, tot, bh, nc, np, (cudaStream_t)stream);
}

// Stage 3: y [bh, s, p] from q, k, v, the gates and h_in [bh, s / l, n, p].
int gla_chunk_output_launch(const float* q, const float* k, const float* v,
                            const float* ld, const float* li,
                            const float* h_in, float* y, int bh, int s, int n,
                            int p, int l, void* stream) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  return chunk_output(q, k, v, ld, li, h_in, y, bh, s, n, p, l,
                      (cudaStream_t)stream);
}

// The same from bfloat16 q, k and v, y bfloat16.
int gla_chunk_output_bf16_launch(const bf16* q, const bf16* k, const bf16* v,
                                 const float* ld, const float* li,
                                 const float* h_in, bf16* y, int bh, int s,
                                 int n, int p, int l, void* stream) {
  if (bad_shape(bh, s, n, p, l)) return (int)cudaErrorInvalidValue;
  return chunk_output_bf16(q, k, v, ld, li, h_in, y, bh, s, n, p, l,
                           (cudaStream_t)stream);
}

// CTAs an SM holds at once of the stage-1 and stage-3 kernels that the
// forward launches for state width n and chunk l (-1 where unknown).
int gla_resident(int n, int l, int* state_ctas, int* output_ctas) {
  if (n <= 0 || l <= 0 || l > kMaxL) return (int)cudaErrorInvalidValue;
  *state_ctas = n <= 16   ? state_resident<1, 2>(l)
                : n <= 32 ? state_resident<2, 4>(l)
                          : state_resident<4, 4>(l);
  *output_ctas =
      n <= kNT ? resident(gla_chunk_output_narrow<float>, kNarrowThreads,
                          output_smem(n, l))
               : resident(gla_chunk_output<float>, kOutThreads,
                          output_smem(n, l));
  return (int)cudaSuccess;
}

// The forward: the three stages on one stream through the scratch states
// [bh, s / l, n, p] and tot [bh, s / l], both float32, from the caller.
int gla_forward_launch(const float* q, const float* k, const float* v,
                       const float* ld, const float* li, float* y,
                       float* states, float* tot, int bh, int s, int n, int p,
                       int l, void* stream) {
  return forward(q, k, v, ld, li, y, states, tot, bh, s, n, p, l,
                 (cudaStream_t)stream);
}

// The same from bfloat16 q, k and v, y bfloat16 (states and tot float32).
int gla_forward_bf16_launch(const bf16* q, const bf16* k, const bf16* v,
                            const float* ld, const float* li, bf16* y,
                            float* states, float* tot, int bh, int s, int n,
                            int p, int l, void* stream) {
  return forward_bf16(q, k, v, ld, li, y, states, tot, bh, s, n, p, l,
                      (cudaStream_t)stream);
}

}  // extern "C"
