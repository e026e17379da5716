// Hand-written Hopper (sm_90a) kernels of the split path: one PSO
// iteration as three launches around the user's own torch operators, for
// every Problem that is not one of the six unconstrained built-ins
// (custom objectives, kernel_fn, and the penalty, projection and repair
// constraint modes). They port the converted forms of the Pallas kernels
// of src/repro/kernels/pso_step.py (their objective through
// dmajor_adapter or kernel_fn, the projection of kernel_projection after
// the clip, the Deb fold of kernel_violation/_pbest_improved), which trace
// the user's jnp functions into their bodies; a CUDA kernel cannot run a
// Python callable, so the iteration is split where those functions run:
//
//   split_advance_kernel<R>  pos and vel against an attractor column,
//                            clipped to the box; no fitness (one thread an
//                            element).
//   -- the caller's torch step: projection (written back into pos), the
//      objective (max_fn or kernel_fn), the violation where Deb applies --
//   split_fold_kernel        the pbest fold (raw fitness, or Deb's rule on
//                            fit/viol against the carried pbest violation)
//                            and the paper's intra-block queue (one CTA a
//                            particle block, one thread a particle).
//   split_publish_kernel     the cross-block stage (one CTA a swarm): the
//                            fused mode's gbest from the folded keys, the
//                            async mode's publish-and-pull or flush; under
//                            an lbest topology the pull is each block's
//                            neighbourhood best of the locals.
//
// In stream order that is synchronous PPSO: every block reads iteration
// t-1's gbest, as the fused kernel of pso_step.cu does with several
// blocks. This file shares no code with pso_step.cu: the device functions
// it needs (the counter hash, the three rules, the queue keys) are copied
// here, with the same __f*_rn chains, so the two builds stay independent.
//
// What bounds them on an H100: the advance reads pos, vel and pbest_pos
// and writes pos and vel, 20 bytes a particle-dimension (20*N*D for a
// swarm: 78.6 MB at N=32768, D=120, beyond the 50 MB L2), against 42
// integer and 16 float operations an element (the two counter-hash draws
// and the rule), so at large N*D it is bound by bytes, and one thread an
// element with the particle index fastest keeps every access coalesced.
// The fold reads 8 to 16 bytes a particle (fit and pbest_fit, plus the
// violations under Deb's rule) and copies a pbest column only where a
// particle improved; the publish moves one column a swarm. Both are small
// beside the advance and beside the user's torch step between them; at
// small swarms the three launches and the host's torch calls, not the
// card, set the time of an iteration (chip_smoke.py phase 6).
//
// Layout: D-major, [D, S*N] with the particle index fastest; swarm s owns
// columns [s*N, (s+1)*N). gp [D, S], gf [S]; the async mode's block-local
// bests lp [D, S*nb], lf [S*nb]. Bounds are the wrappers' member table
// [members, 4, D] (lo, hi, max_v, span) and fids[S] (null: member 0).
// seeds[S] and its[S] are uint32 counters; the advance of iteration
// its[s] + it_off + 1 draws at element index particle*D + dim, local to the
// swarm, as every engine of the port does. float32 only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kStreamR1 = 2u, kStreamR2 = 3u;
constexpr int kFoldThreads = 512;
constexpr int kPublishThreads = 256;
constexpr int kAdvanceThreads = 256;

// Fold and publish modes (kernels/pso_split.py MODES).
constexpr int kQueue = 0, kFused = 1, kAsync = 2;
// The publish kernel's per-swarm action in the async mode (2: publish
// only, the end of a call).
constexpr int kActNone = 0, kActSync = 1;

struct Coef { float w, c1, c2, k0, k1, k2; };

// ---- counter hash: repro_torch/core/rng.py, bit for bit -------------------
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u; x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t it,
                                           uint32_t stream, uint32_t idx) {
  uint32_t h = seed * 0x9E3779B9u + it * 0x85EBCA6Bu + stream * 0xC2B2AE35u +
               idx * 0x27D4EB2Fu;
  h = mix32(h);
  h = mix32(h ^ (idx * 0x9E3779B9u + it * 0xC2B2AE35u));
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

// ---- the three update rules (core/update_rules.py) -------------------------
template <int R>
__device__ __forceinline__ void advance(const Coef& p, float r1, float r2,
                                        float& x, float& v, float pb, float g,
                                        float lo, float hi, float mv,
                                        float span) {
  if (R == 0) {          // pso: v = w v + c1 r1 (pb - x) + c2 r2 (g - x)
    const float a = __fmul_rn(p.w, v);
    const float b = __fmul_rn(__fmul_rn(p.c1, r1), __fsub_rn(pb, x));
    const float c = __fmul_rn(__fmul_rn(p.c2, r2), __fsub_rn(g, x));
    v = fminf(fmaxf(__fadd_rn(__fadd_rn(a, b), c), -mv), mv);
    x = fminf(fmaxf(__fadd_rn(x, v), lo), hi);
  } else if (R == 1) {   // sso: copy from gbest / pbest / keep / resample
    const float fresh = __fadd_rn(lo, __fmul_rn(span, r2));
    x = r1 < p.k0 ? g : (r1 < p.k1 ? pb : (r1 < p.k2 ? x : fresh));
    x = fminf(fmaxf(x, lo), hi);
  } else {               // lowcost: Bernoulli-selected difference terms
    const float a = r1 < 0.5f ? __fsub_rn(pb, x) : 0.0f;
    const float b = r2 < 0.5f ? __fsub_rn(g, x) : 0.0f;
    v = fminf(fmaxf(__fadd_rn(__fadd_rn(v, a), b), -mv), mv);
    x = fminf(fmaxf(__fadd_rn(x, v), lo), hi);
  }
}

// ---- queue keys: (order-preserving fitness bits) << 32 | (~index) ----------
// A larger key is a higher fitness, on equal fitness the lower index: one
// 64-bit atomicMax is the queue's scan with the reference's first-lane
// tie-break. No key is 0, so 0 stands for an empty queue.
__device__ __forceinline__ unsigned long long make_key(float f, int i) {
  uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));   // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)i);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

// Neighbour k of block b under an lbest topology (core/topology.py
// kernel_neighbor_ids): ring (1) b-1, b+1; von Neumann (2), on a rows x
// cols torus, the row above, below, the column left, right.
constexpr int kRing = 1, kVonNeumann = 2;
__device__ __forceinline__ int neighbor_id(int b, int nb, int topo, int rows,
                                           int cols, int k) {
  if (topo == kRing) return k == 0 ? (b + nb - 1) % nb : (b + 1) % nb;
  const int r = b / cols, c = b - r * cols;
  switch (k) {
    case 0: return ((r + rows - 1) % rows) * cols + c;
    case 1: return ((r + 1) % rows) * cols + c;
    case 2: return r * cols + (c + cols - 1) % cols;
    default: return r * cols + (c + 1) % cols;
  }
}

// Deb's rule (core/constraints.py deb_improved).
__device__ __forceinline__ bool deb_improved(float fn, float vn, float fo,
                                             float vo) {
  const bool a = vn <= 0.0f, b = vo <= 0.0f;
  return (a && !b) || (a && b && fn > fo) || (!a && !b && vn < vo);
}

// ---- split_advance_kernel --------------------------------------------------
// One thread an element (k, col) of the [D, S*N] arrays, grid-stride:
// neighbouring threads touch neighbouring columns of one row. The attractor
// of column col is column col / gdiv of the attractor array (gdiv = N: gp, one
// column a swarm; gdiv = bn: lp, one column a particle block).
template <int R>
__global__ void __launch_bounds__(kAdvanceThreads) split_advance_kernel(
    float* __restrict__ pos, float* __restrict__ vel,
    const float* __restrict__ pbp, const float* __restrict__ attractor,
    const float* __restrict__ bounds, const int* __restrict__ fids,
    const uint32_t* __restrict__ seeds, const uint32_t* __restrict__ its,
    int n, int d, int s_cnt, int gdiv, uint32_t it_off, Coef cf) {
  const int ld = s_cnt * n;
  const int gld = ld / gdiv;
  const size_t total = (size_t)d * ld;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(e / ld);
    const int col = (int)(e - (size_t)k * ld);
    const int s = col / n;
    const int i = col - s * n;
    const float* b = bounds + (size_t)(fids ? fids[s] : 0) * 4 * d;
    const uint32_t it = its[s] + it_off + 1u;
    const uint32_t idx = (uint32_t)i * (uint32_t)d + (uint32_t)k;
    const float r1 = uniform01(seeds[s], it, kStreamR1, idx);
    const float r2 = uniform01(seeds[s], it, kStreamR2, idx);
    float x = pos[e], v = vel[e];
    advance<R>(cf, r1, r2, x, v, pbp[e],
               attractor[(size_t)k * gld + col / gdiv], b[k], b[d + k],
               b[2 * d + k], b[3 * d + k]);
    pos[e] = x;
    vel[e] = v;
  }
}

// ---- split_fold_kernel -----------------------------------------------------
// One CTA a particle block (blockIdx.x = s * nb + b), one thread a particle
// (threads stride over a block longer than the CTA). viol null: the raw
// fitness fold; else Deb's rule against pbv, which carries the violation
// of each pbest. The queue holds the lanes whose raw fitness beats the
// attractor's fitness (gf[s], or the async mode's lf[s*nb + b]); gbest is not
// Deb-gated, as in the reference.
__global__ void __launch_bounds__(kFoldThreads) split_fold_kernel(
    const float* __restrict__ pos, float* __restrict__ pbp,
    float* __restrict__ pbf, float* __restrict__ pbv,
    const float* __restrict__ fit, const float* __restrict__ viol,
    const float* __restrict__ gf, float* __restrict__ lp,
    float* __restrict__ lf, unsigned long long* __restrict__ keys,
    float* __restrict__ aux_fit, int* __restrict__ aux_idx,
    int* __restrict__ counts, int n, int d, int bn, int s_cnt, int mode) {
  __shared__ unsigned long long s_key;
  __shared__ int s_imp;
  const int nb = n / bn;
  const int blk = blockIdx.x;
  const int s = blk / nb, b = blk - s * nb;
  const int ld = s_cnt * n;
  const int base = s * n + b * bn;          // the block's first column
  const float g = mode == kAsync ? lf[blk] : gf[s];
  if (threadIdx.x == 0) {
    s_key = 0ull;
    s_imp = 0;
  }
  __syncthreads();
  bool imp_any = false;
  for (int l = threadIdx.x; l < bn; l += blockDim.x) {
    const int col = base + l;
    const float f = fit[col];
    bool imp;
    float v = 0.0f;
    if (viol) {
      v = viol[col];
      imp = deb_improved(f, v, pbf[col], pbv[col]);
    } else {
      imp = f > pbf[col];
    }
    if (imp) {              // rare at steady state: copy the column
      imp_any = true;
      pbf[col] = f;
      if (viol) pbv[col] = v;
      for (int k = 0; k < d; ++k) {
        const size_t o = (size_t)k * ld + col;
        pbp[o] = pos[o];
      }
    }
    if (f > g) atomicMax(&s_key, make_key(f, b * bn + l));   // the queue
  }
  if (imp_any) s_imp = 1;
  __syncthreads();
  const unsigned long long key = s_key;
  if (threadIdx.x == 0 && counts) {
    if (key) {
      atomicAdd(counts + 3 * s, 1);                 // queue updates
      if (mode == kFused) atomicAdd(counts + 3 * s + 1, 1);  // publications
    }
    if (s_imp) atomicAdd(counts + 3 * s + 2, 1);    // block improvements
  }
  if (mode == kQueue) {
    if (threadIdx.x == 0) {
      const int w = key ? key_index(key) : b * bn;
      aux_fit[blk] = key ? fit[s * n + w] : -__int_as_float(0x7f800000);
      aux_idx[blk] = w;
    }
  } else if (mode == kFused) {
    if (threadIdx.x == 0 && key) atomicMax(keys + s, key);
  } else if (key) {         // async: the block's winner into its local best
    const int wc = s * n + key_index(key);
    const int lld = s_cnt * nb;
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      lp[(size_t)k * lld + blk] = pos[(size_t)k * ld + wc];
    if (threadIdx.x == 0) lf[blk] = fit[wc];
  }
}

// ---- split_publish_kernel --------------------------------------------------
// One CTA a swarm. Fused mode: the winner of keys[s] (the best lane of the
// iteration that beat gf[s], every block's key folded) becomes gbest, and
// keys[s] is cleared for the next iteration. Async mode, act[s]: kActSync
// publishes the best local (first on ties) into gbest where it beats it,
// then pulls gbest into every local; 2 publishes only (the end of a call);
// kActNone leaves the swarm alone (core/pso.py _sync_point). Under an
// lbest topology (topo 1 or 2) the pull of kActSync is core/topology.py's
// block_neighbor_best: every local becomes the best of itself and its
// neighbours (self first, strict >), all read before any is written, so
// the swarm's locals are first copied to `scratch` ([D+1, S*nb]: lp's rows,
// then lf) and read from there.
__global__ void __launch_bounds__(kPublishThreads) split_publish_kernel(
    const float* __restrict__ pos, const float* __restrict__ fit,
    float* __restrict__ gp, float* __restrict__ gf, float* __restrict__ lp,
    float* __restrict__ lf, unsigned long long* __restrict__ keys,
    const int* __restrict__ act, int* __restrict__ counts,
    float* __restrict__ scratch, int n, int d, int nb, int s_cnt, int mode,
    int topo, int rows, int cols) {
  __shared__ unsigned long long s_key;
  const int s = blockIdx.x;
  const int ld = s_cnt * n;
  if (mode == kFused) {
    const unsigned long long key = keys[s];
    __syncthreads();                   // every thread has read keys[s]
    if (!key) return;
    const int wc = s * n + key_index(key);
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      gp[(size_t)k * s_cnt + s] = pos[(size_t)k * ld + wc];
    if (threadIdx.x == 0) {
      gf[s] = fit[wc];
      keys[s] = 0ull;
    }
    return;
  }
  const int a = act[s];
  if (a == kActNone) return;
  const int lld = s_cnt * nb;
  if (threadIdx.x == 0) s_key = 0ull;
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += blockDim.x)
    atomicMax(&s_key, make_key(lf[s * nb + j], j));
  __syncthreads();
  const int slot = s * nb + key_index(s_key);
  const float old = gf[s];
  const float bf = lf[slot];
  const bool take = bf > old;
  if (take) {
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      gp[(size_t)k * s_cnt + s] = lp[(size_t)k * lld + slot];
  }
  __syncthreads();                     // every thread has read old and bf
  if (threadIdx.x == 0 && take) {
    gf[s] = bf;
    if (counts) atomicAdd(counts + 3 * s + 1, 1);   // publications
  }
  if (a != kActSync) return;
  if (topo) {
    const float* slf = scratch + (size_t)d * lld;
    for (int e = threadIdx.x; e < nb * (d + 1); e += blockDim.x) {
      const int k = e / nb, j = e - k * nb;
      scratch[(size_t)k * lld + s * nb + j] =
          k < d ? lp[(size_t)k * lld + s * nb + j] : lf[s * nb + j];
    }
    __syncthreads();
    const int nbrs = topo == kRing ? 2 : 4;
    for (int e = threadIdx.x; e < nb * (d + 1); e += blockDim.x) {
      const int k = e / nb, j = e - k * nb;
      int w = j;
      float best = slf[s * nb + j];
      for (int q = 0; q < nbrs; ++q) {
        const int o = neighbor_id(j, nb, topo, rows, cols, q);
        if (slf[s * nb + o] > best) {
          best = slf[s * nb + o];
          w = o;
        }
      }
      const size_t row = (size_t)k * lld + s * nb;
      if (k < d)
        lp[row + j] = scratch[row + w];
      else
        lf[s * nb + j] = best;
    }
    return;
  }
  const float g = take ? bf : old;
  for (int e = threadIdx.x; e < nb * d; e += blockDim.x) {
    const int k = e / nb, j = e - k * nb;
    lp[(size_t)k * lld + s * nb + j] = gp[(size_t)k * s_cnt + s];
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) lf[s * nb + j] = g;
}

typedef void (*AdvanceKernel)(float*, float*, const float*, const float*,
                              const float*, const int*, const uint32_t*,
                              const uint32_t*, int, int, int, int, uint32_t,
                              Coef);
const AdvanceKernel kAdvance[3] = {split_advance_kernel<0>,
                                   split_advance_kernel<1>,
                                   split_advance_kernel<2>};

int grid_for(size_t total) {
  // Enough CTAs to fill the card many times over; the loop strides past.
  const size_t want = (total + kAdvanceThreads - 1) / kAdvanceThreads;
  return (int)(want < 65536 ? want : 65536);
}

}  // namespace

extern "C" {

// One advance of every element of the [D, S*N] state (iteration
// its[s] + it_off + 1 of swarm s) with rule `rule`; the attractor of
// column col is column col / gdiv of `attractor`.
int pso_split_advance(float* pos, float* vel, const float* pbp,
                      const float* attractor, const float* bounds,
                      const int* fids, const unsigned* seeds,
                      const unsigned* its, int n, int d, int s_cnt, int gdiv,
                      unsigned it_off, int rule, float w, float c1, float c2,
                      float k0, float k1, float k2, void* stream) {
  if (n < 1 || d < 1 || s_cnt < 1 || gdiv < 1 || n % gdiv ||
      rule < 0 || rule > 2 || (size_t)s_cnt * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)d * s_cnt * n;
  const Coef cf{w, c1, c2, k0, k1, k2};
  kAdvance[rule]<<<grid_for(total), kAdvanceThreads, 0,
                   (cudaStream_t)stream>>>(
      pos, vel, pbp, attractor, bounds, fids, (const uint32_t*)seeds,
      (const uint32_t*)its, n, d, s_cnt, gdiv, (uint32_t)it_off, cf);
  return (int)cudaGetLastError();
}

// The pbest fold and the intra-block queue of every particle block, in
// mode 0 (queue: aux_fit/aux_idx [S*nb]), 1 (fused: keys[S]) or 2 (async:
// lp/lf). viol and pbv null: the raw fold; counts null: no counting.
int pso_split_fold(const float* pos, float* pbp, float* pbf, float* pbv,
                   const float* fit, const float* viol, const float* gf,
                   float* lp, float* lf, unsigned long long* keys,
                   float* aux_fit, int* aux_idx, int* counts, int n, int d,
                   int bn, int s_cnt, int mode, void* stream) {
  if (n < 1 || d < 1 || s_cnt < 1 || bn < 1 || n % bn ||
      (viol && !pbv) || (mode == kQueue && !(aux_fit && aux_idx)) ||
      (mode == kFused && !keys) || (mode == kAsync && !(lp && lf)) ||
      mode < kQueue || mode > kAsync || (size_t)s_cnt * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const int threads = bn < kFoldThreads ? (bn + 31) / 32 * 32 : kFoldThreads;
  split_fold_kernel<<<(unsigned)(s_cnt * (n / bn)), threads, 0,
                      (cudaStream_t)stream>>>(
      pos, pbp, pbf, pbv, fit, viol, gf, lp, lf, keys, aux_fit, aux_idx,
      counts, n, d, bn, s_cnt, mode);
  return (int)cudaGetLastError();
}

// The cross-block stage of every swarm: mode 1 (fused, keys[S]) or 2
// (async, act[S] of 0 none / 1 publish and pull / 2 publish only). topo 0
// pulls gbest; 1 (ring) and 2 (von Neumann on a rows x cols torus of the
// nb blocks) pull the neighbourhood best, through scratch [D+1, S*nb].
int pso_split_publish(const float* pos, const float* fit, float* gp,
                      float* gf, float* lp, float* lf,
                      unsigned long long* keys, const int* act, int* counts,
                      float* scratch, int n, int d, int nb, int s_cnt,
                      int mode, int topo, int rows, int cols, void* stream) {
  if (n < 1 || d < 1 || s_cnt < 1 || nb < 1 ||
      (mode == kFused && !keys) || (mode == kAsync && !(lp && lf && act)) ||
      (mode != kFused && mode != kAsync) || topo < 0 || topo > kVonNeumann ||
      (topo && (mode != kAsync || !scratch)) ||
      (topo == kVonNeumann && (rows < 1 || cols < 1 || rows * cols != nb)))
    return (int)cudaErrorInvalidValue;
  split_publish_kernel<<<(unsigned)s_cnt, kPublishThreads, 0,
                         (cudaStream_t)stream>>>(
      pos, fit, gp, gf, lp, lf, keys, act, counts, scratch, n, d, nb, s_cnt,
      mode, topo, rows, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
