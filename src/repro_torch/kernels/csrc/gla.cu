// Hand-written Hopper (sm_90a) kernel for chunked gated linear attention
// (GLA), the forward pass of the hymba SSD branch and the xLSTM mLSTM
// blocks. Replaces the Pallas TPU kernel _gla_kernel / gla_forward_call of
// src/repro/kernels/gla.py, written from what it computes:
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
// the kernel takes the caller's.
//
// Layout: q, k [BH, S, N], v and y [BH, S, P], ld and li [BH, S], float32,
// S a multiple of L. One CTA per (batch.head, tile of kPT columns of P)
// walks the chunks in order, the TPU kernel's sequential grid axis turned
// into a loop. It keeps its [N, kPT] slice of H in shared memory for the
// whole walk (the full H of the xLSTM-350M head shape, N = 256 by P = 257,
// is 263 KB, over the 227 KB a CTA can have, so P is tiled). The chunk's
// q and k are streamed over N in tiles of kNT columns, and in one pass over
// a tile the CTA accumulates q k^T and q H in registers and then advances
// the tile's rows of H; q k^T o W is recomputed by every P-tile of a
// (batch.head). The products are plain FMAs of 256 threads on register
// tiles (16 x 16 threads: rows ty + 16a, columns tx + 16b), a simple kernel
// that is right first: no tensor cores, no asynchronous copies.
//
// Masked entries (j > i) are skipped. In the reference they are
// exp(-80) ~ 1.8e-35 times q.k, not 0; the difference is below float32's
// resolution of any unmasked term.
//
// What bounds it on an H100 at the hymba-1.5B SSD shape (B=4, S=4096,
// H=25, N=16, P=128, L=128): 120 MB in and out (q, k 6.6 MB each, v, y
// 52 MB each), 36 us at 3.35 TB/s; 11 GFLOP of float32 products on the
// causal half, 0.16 ms at 67 TFLOP/s. Operations bound it; this kernel
// runs without the tensor cores and reads its operands from shared memory,
// so it sits well above that bound (chip_smoke.py measures it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxL = 128;         // longest chunk: 8 rows a thread
constexpr int kRows = kMaxL / 16;
constexpr int kPT = 64;            // columns of P a CTA owns
constexpr int kCols = kPT / 16;
constexpr int kNT = 32;            // columns of N in a streamed q/k tile
constexpr int kSmemMax = 232448;   // what an H100 CTA may opt into
constexpr float kClipLo = -80.0f, kClipHi = 20.0f;

__device__ __forceinline__ float clipped_exp(float x) {
  return expf(fminf(fmaxf(x, kClipLo), kClipHi));
}

// Shared memory, in floats: H [N][kPT], A [L][L+1], v [L][kPT],
// q and k tiles [L][kNT+1] each (rows padded against bank conflicts), and
// cum, li, exp(cum), the state weights [L] each.
size_t smem_floats(int n, int l) {
  return (size_t)n * kPT + (size_t)l * (l + 1) + (size_t)l * kPT +
         2 * (size_t)l * (kNT + 1) + 4 * (size_t)l;
}

__global__ void __launch_bounds__(kThreads) gla_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ li, float* __restrict__ y, int S, int N, int P,
    int L) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * kPT;
  const int pw = min(kPT, P - p0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int LA = L + 1, QA = kNT + 1;
  float* H = sm;
  float* A = H + (size_t)N * kPT;
  float* vs = A + (size_t)L * LA;
  float* qs = vs + (size_t)L * kPT;
  float* ks = qs + (size_t)L * QA;
  float* cum = ks + (size_t)L * QA;
  float* lis = cum + L;
  float* ei = lis + L;
  float* wj = ei + L;

  const float* qb = q + (size_t)bh * S * N;
  const float* kb = k + (size_t)bh * S * N;
  const float* vb = v + (size_t)bh * S * P;
  const float* ldb = ld + (size_t)bh * S;
  const float* lib = li + (size_t)bh * S;
  float* yb = y + (size_t)bh * S * P;

  for (int e = tid; e < N * kPT; e += kThreads) H[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += L) {
    for (int i = tid; i < L; i += kThreads) {
      cum[i] = ldb[c0 + i];
      lis[i] = lib[c0 + i];
    }
    for (int e = tid; e < L * kPT; e += kThreads) {
      const int j = e / kPT, c = e % kPT;
      vs[e] = c < pw ? vb[(size_t)(c0 + j) * P + p0 + c] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {                  // the running sum, in order
      float s = 0.0f;
      for (int i = 0; i < L; ++i) {
        s += cum[i];
        cum[i] = s;
      }
    }
    __syncthreads();
    const float tot = cum[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      ei[i] = clipped_exp(cum[i]);
      wj[i] = clipped_exp(tot - cum[i] + lis[i]);
    }

    float acc_a[kRows][kRows];      // (q k^T)[ty + 16a][tx + 16b]
    float acc_y[kRows][kCols];      // (q H)[ty + 16a][tx + 16c]
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc_a[a][b] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc_y[a][c] = 0.0f;
    }
    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int nw = min(kNT, N - n0);
      __syncthreads();               // the last tile's readers are done
      for (int e = tid; e < L * kNT; e += kThreads) {
        const int i = e / kNT, c = e % kNT;
        const size_t o = (size_t)(c0 + i) * N + n0 + c;
        qs[i * QA + c] = c < nw ? qb[o] : 0.0f;
        ks[i * QA + c] = c < nw ? kb[o] : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < nw; ++c) {
        float qa[kRows], kk[kRows], hh[kCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int i = ty + 16 * a;
          qa[a] = i < L ? qs[i * QA + c] : 0.0f;
          kk[a] = tx + 16 * a < L ? ks[(tx + 16 * a) * QA + c] : 0.0f;
        }
#pragma unroll
        for (int b = 0; b < kCols; ++b) hh[b] = H[(n0 + c) * kPT + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
#pragma unroll
          for (int b = 0; b < kRows; ++b) acc_a[a][b] += qa[a] * kk[b];
#pragma unroll
          for (int b = 0; b < kCols; ++b) acc_y[a][b] += qa[a] * hh[b];
        }
      }
      __syncthreads();               // every read of this tile's H rows done
      // H rows n0 + ty + 16r of the tile: exp(tot) H + sum_j k_j wj_j v_j
      const float e_tot = clipped_exp(tot);
#pragma unroll
      for (int r = 0; r < kNT / 16; ++r) {
        const int nn = ty + 16 * r;
        if (nn >= nw) continue;
        float acc_h[kCols];
#pragma unroll
        for (int b = 0; b < kCols; ++b) acc_h[b] = 0.0f;
        for (int j = 0; j < L; ++j) {
          const float kw = ks[j * QA + nn] * wj[j];
#pragma unroll
          for (int b = 0; b < kCols; ++b)
            acc_h[b] += kw * vs[j * kPT + tx + 16 * b];
        }
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          float* h = H + (n0 + nn) * kPT + tx + 16 * b;
          *h = *h * e_tot + acc_h[b];
        }
      }
    }
    // A = q k^T o W on the causal half, 0 above it
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int j = tx + 16 * b;
        if (i < L && j < L)
          A[i * LA + j] = j <= i ? acc_a[a][b] *
                                       clipped_exp(cum[i] - cum[j] + lis[j])
                                 : 0.0f;
      }
    }
    __syncthreads();
    // y = exp(cum) o (q H) + A v, rows ty + 16a, columns tx + 16c
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const float e = ty + 16 * a < L ? ei[ty + 16 * a] : 0.0f;
#pragma unroll
      for (int b = 0; b < kCols; ++b) acc_y[a][b] *= e;
    }
    for (int j = 0; j < L; ++j) {
      float vv[kCols];
#pragma unroll
      for (int b = 0; b < kCols; ++b) vv[b] = vs[j * kPT + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = ty + 16 * a;
        const float w = i < L ? A[i * LA + j] : 0.0f;
#pragma unroll
        for (int b = 0; b < kCols; ++b) acc_y[a][b] += w * vv[b];
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = tx + 16 * b;
        if (i < L && c < pw) yb[(size_t)(c0 + i) * P + p0 + c] = acc_y[a][b];
      }
    }
    __syncthreads();                 // before the next chunk's loads
  }
}

}  // namespace

extern "C" {

// y [bh, s, p] from q, k [bh, s, n], v [bh, s, p], ld, li [bh, s]: one
// launch of bh x ceil(p / 64) CTAs. Chunks of l <= 128 (s a multiple of l);
// the shared memory it needs, (64 n + l (l + 1) + 64 l + 66 l + 4 l)
// floats, must fit in 227 KB.
int gla_forward_launch(const float* q, const float* k, const float* v,
                       const float* ld, const float* li, float* y, int bh,
                       int s, int n, int p, int l, void* stream) {
  if (bh <= 0 || s <= 0 || n <= 0 || p <= 0 || l <= 0 || l > kMaxL || s % l)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(n, l) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)gla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)bh, (unsigned)((p + kPT - 1) / kPT));
  gla_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(q, k, v, ld, li,
                                                             y, s, n, p, l);
  return (int)cudaGetLastError();
}

}  // extern "C"
