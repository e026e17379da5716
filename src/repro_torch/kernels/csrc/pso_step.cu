// Hand-written Hopper (sm_90a) kernels for the cuPSO main path.
//
// Two kernels, each a port of one Pallas TPU kernel of
// src/repro/kernels/pso_step.py, written from what that kernel computes:
//
//   fused_kernel  replaces pso_step.fused_call (body _make_sync_kernel()):
//                 `iters` iterations of the fused queue-lock (paper §4.2).
//   async_kernel  replaces pso_step.fused_async_call (body
//                 _make_async_kernel(), chunk loop _async_chunk_body): the
//                 paper's enhanced asynchronous queue-lock.
//
// Layout: D-major, arrays [D, N] with the particle index fastest (§5.1
// coalescing rule): thread l of a block works on particles base + l,
// base + l + blockDim, ..., so neighbouring threads touch neighbouring
// addresses of every dimension. Each thread loops over D for its particle
// and accumulates the objective (this replaces the TPU kernel's masked
// sublane sums). float32 only.
//
// What bounds them on an H100: per iteration a particle-dimension reads
// pos, vel and pbest_pos and writes pos and vel (20 bytes), so a pass over
// the swarm is 20*N*D + 8*N bytes: at an H100 SXM's 3.35 TB/s (data sheet)
// 1.1 us at N=131072, D=1 (3.7 MB, inside the 50 MB L2) and 23.5 us at
// N=32768, D=120 (78.9 MB, beyond it). Against that each element of the
// cubic/pso path spends 42 integer operations (two counter-hash draws)
// and 24 float ones (the rule, the objective); integers issue at a quarter
// of the data sheet's 67 TFLOP/s, so at D=1 the operations take 0.33 us an
// iteration (chip_smoke.py counts them). The kernels are bound by that
// integer work and, for the fused kernel at small D, by the grid-wide
// synchronisation of every iteration, not by bytes. The design therefore
// keeps the whole iteration loop inside one launch (no per-iteration launch
// latency), keeps the attractor and the
// bounds in shared memory, and publishes one 64-bit key per CTA only when
// the CTA has a candidate (the paper's rare-improvement predicate).
//
// Arithmetic uses the __f*_rn intrinsics so that nvcc does not contract
// into FMAs: the kernels then round exactly as the plain PyTorch versions
// (kernels/pso_step.py) do, which is what chip_smoke.py holds them to.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kFitnessCount = 6;   // core/fitness.py FITNESS_IDS order
constexpr int kRuleCount = 3;      // core/update_rules.py RULE_IDS order
constexpr uint32_t kStreamR1 = 2u, kStreamR2 = 3u;
constexpr int kBatch = 4;          // dimensions loaded together

struct Params {
  float* pos; float* vel; float* pbp; float* pbf;   // [D,N] x3, [N]
  float* gp; float* gf;                              // [D], [1]
  const float* bounds;                               // [4,D]: lo, hi, max_v, span
  float* lp; float* lf;                              // async: [D,nb], [nb]
  unsigned long long* keys;                          // fused: [2] winner keys
  float* cand;                                       // fused: [2,nb,D] candidates
  unsigned* lock;                                    // async: [mutex, sequence]
  int n, d, bn, iters, chunk;
  uint32_t seed, it0;
  float w, c1, c2, k0, k1, k2;
};

// ---- counter hash: repro/core/rng.py, bit for bit --------------------------
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

// ---- the three update rules (core/update_rules.py) ------------------------
template <int R>
__device__ __forceinline__ void advance(const Params& p, float r1, float r2,
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

// ---- the six objectives (core/fitness.py), one streaming pass over D -------
constexpr float kTwoPi = 6.283185307179586f;

template <int F>
struct Objective {
  float s = 0.0f, t = 0.0f, prev = 0.0f;
  float p = 1.0f;

  __device__ __forceinline__ void add(int k, float x) {
    const float xx = __fmul_rn(x, x);
    if (F == 0) {          // cubic: x^3 - 0.8 x^2 - 1000 x + 8000
      const float v = __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(xx, x),
                                                    __fmul_rn(0.8f, xx)),
                                          __fmul_rn(1000.0f, x)), 8000.0f);
      s = __fadd_rn(s, v);
    } else if (F == 1) {   // sphere
      s = __fadd_rn(s, xx);
    } else if (F == 2) {   // rosenbrock: pairs (prev, x); D == 1 uses t
      if (k > 0) {
        const float u = __fsub_rn(x, __fmul_rn(prev, prev));
        const float q = __fsub_rn(1.0f, prev);
        s = __fadd_rn(s, __fadd_rn(__fmul_rn(100.0f, __fmul_rn(u, u)),
                                   __fmul_rn(q, q)));
      } else {
        const float q = __fsub_rn(1.0f, x);
        t = __fmul_rn(q, q);
      }
      prev = x;
    } else if (F == 3) {   // griewank
      s = __fadd_rn(s, xx);
      p = __fmul_rn(p, cosf(__fdiv_rn(x, sqrtf((float)(k + 1)))));
    } else if (F == 4) {   // rastrigin
      s = __fadd_rn(s, __fsub_rn(xx, __fmul_rn(10.0f,
                                               cosf(__fmul_rn(kTwoPi, x)))));
    } else {               // ackley
      s = __fadd_rn(s, xx);
      t = __fadd_rn(t, cosf(__fmul_rn(kTwoPi, x)));
    }
  }

  __device__ __forceinline__ float result(int d) const {
    if (F == 0) return s;
    if (F == 1) return -s;
    if (F == 2) return d == 1 ? -t : -s;
    if (F == 3) return -__fadd_rn(__fsub_rn(__fdiv_rn(s, 4000.0f), p), 1.0f);
    if (F == 4) return -__fadd_rn((float)(10.0 * d), s);
    const float fd = (float)d;
    const float e1 = expf(__fmul_rn(-0.2f, sqrtf(__fdiv_rn(s, fd))));
    const float e2 = expf(__fdiv_rn(t, fd));
    return -__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(-20.0f, e1), e2), 20.0f),
                      2.718281828459045f);
  }
};

// One iteration of particle i against the attractor att[D] (gbest or the
// block's local best): advance, objective, pbest fold. Returns the fitness.
template <int F, int R>
__device__ __forceinline__ float step_particle(const Params& p, int i,
                                               uint32_t it, const float* sm) {
  const int D = p.d;
  const float* att = sm;
  const float* lo = sm + D;
  const float* hi = sm + 2 * D;
  const float* mv = sm + 3 * D;
  const float* span = sm + 4 * D;
  Objective<F> obj;
  const uint32_t idx0 = (uint32_t)i * (uint32_t)D;   // index = particle*D + dim
  auto update = [&](int k, float x, float v, float pb) {
    const size_t o = (size_t)k * p.n + i;
    const float r1 = uniform01(p.seed, it, kStreamR1, idx0 + (uint32_t)k);
    const float r2 = uniform01(p.seed, it, kStreamR2, idx0 + (uint32_t)k);
    advance<R>(p, r1, r2, x, v, pb, att[k], lo[k], hi[k], mv[k], span[k]);
    p.pos[o] = x;
    p.vel[o] = v;
    obj.add(k, x);
  };
  // One thread walks all D dimensions of its particle, so the loads of
  // kBatch dimensions are issued together before any of them is used;
  // otherwise every dimension waits out a memory latency in turn. The
  // remainder (all of D when D < kBatch) takes one dimension at a time.
  int k = 0;
  for (; k + kBatch <= D; k += kBatch) {
    float x[kBatch], v[kBatch], pb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t o = (size_t)(k + j) * p.n + i;
      x[j] = p.pos[o];
      v[j] = p.vel[o];
      pb[j] = p.pbp[o];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) update(k + j, x[j], v[j], pb[j]);
  }
  for (; k < D; ++k) {
    const size_t o = (size_t)k * p.n + i;
    update(k, p.pos[o], p.vel[o], p.pbp[o]);
  }
  const float f = obj.result(D);
  if (f > p.pbf[i]) {           // rare at steady state: copy the column
    p.pbf[i] = f;
    for (int c = 0; c < D; ++c) {
      const size_t o = (size_t)c * p.n + i;
      p.pbp[o] = p.pos[o];
    }
  }
  return f;
}

// Queue keys: (order-preserving fitness bits) << 32 | (0xFFFFFFFF - index).
// A larger key is a higher fitness, and on equal fitness the lower particle
// index: one 64-bit atomicMax is the queue's scan with the reference's
// first-lane tie-break (pso_step._queue_best).
__device__ __forceinline__ unsigned long long make_key(float f, int i) {
  uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));   // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)i);
}
__device__ __forceinline__ float key_fit(unsigned long long key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

// Shared memory: att[D] then lo, hi, max_v, span rows.
__device__ __forceinline__ void load_bounds(const Params& p, float* sm) {
  for (int k = threadIdx.x; k < 4 * p.d; k += blockDim.x)
    sm[p.d + k] = p.bounds[k];
}

// Each thread's particles: one pass, returning the thread's best queue key
// (0 when none of its particles beats `best`).
template <int F, int R>
__device__ __forceinline__ unsigned long long step_block(const Params& p,
                                                         uint32_t it,
                                                         const float* sm,
                                                         float best) {
  unsigned long long mine = 0ull;
  const int base = blockIdx.x * p.bn;
  for (int l = threadIdx.x; l < p.bn; l += blockDim.x) {
    const int i = base + l;
    const float f = step_particle<F, R>(p, i, it, sm);
    if (f > best) {
      const unsigned long long key = make_key(f, i);
      mine = key > mine ? key : mine;
    }
  }
  return mine;
}

// ---------------------------------------------------------------------------
// Fused queue-lock: one persistent cooperative launch, one CTA per particle
// block, the iteration loop inside, a grid-wide sync between iterations.
//
// Semantics: synchronous PPSO. Every CTA reads the gbest of iteration t-1
// (the TPU kernel's block b also sees what blocks 0..b-1 published in the
// same iteration, an artifact of its sequential grid; concurrent CTAs cannot
// give that order without running one after another). With one block both
// agree exactly.
//
// Publication (§5.3): only the winner's index travels, inside the key. Each
// CTA with a candidate raises keys[t&1] with one atomicMax and copies its
// block winner's column into cand[t&1][block]. After grid.sync() every CTA
// decodes the key and reads the winner's D floats from that candidate
// column into its shared gbest.
//
// Races, and what prevents them:
//  * Key: a fast CTA raises the key of iteration t+1 while a slow CTA may
//    still be reading the key of iteration t. Two slots (t&1) keep them
//    apart; slot t&1 is raised again only in iteration t+2, after the sync
//    that ends t+1, which every reader of iteration t has passed. The slot
//    is never reset: a key left from iteration t-2 carries a fitness <=
//    gbest(t-1), so a reader that takes a key only if its fitness beats its
//    gbest ignores it, and any candidate of iteration t (fitness >
//    gbest(t-1)) outranks it under atomicMax.
//  * Position: the winner's column in `pos` is overwritten by its owner in
//    iteration t+1, possibly before a slow CTA has gathered it. The gather
//    therefore reads the candidate copy, which is double-buffered the same
//    way as the key.
// ---------------------------------------------------------------------------
template <int F, int R>
__global__ void __launch_bounds__(kMaxThreads, 2) fused_kernel(Params p) {
  extern __shared__ float sm[];
  __shared__ unsigned long long s_key;
  cg::grid_group grid = cg::this_grid();
  const int D = p.d, tid = threadIdx.x, nt = blockDim.x;
  load_bounds(p, sm);
  for (int k = tid; k < D; k += nt) sm[k] = p.gp[k];
  if (tid == 0) s_key = 0ull;
  float gf = *p.gf;
  __syncthreads();
  for (int t = 0; t < p.iters; ++t) {
    const uint32_t it = p.it0 + (uint32_t)t + 1u;
    const int slot = t & 1;
    const unsigned long long mine = step_block<F, R>(p, it, sm, gf);
    if (mine) atomicMax(&s_key, mine);           // the intra-block queue
    __syncthreads();
    const unsigned long long bk = s_key;
    if (bk) {
      const int wi = key_index(bk);
      float* c = p.cand + ((size_t)slot * gridDim.x + blockIdx.x) * D;
      for (int k = tid; k < D; k += nt) c[k] = p.pos[(size_t)k * p.n + wi];
      if (tid == 0) atomicMax(p.keys + slot, bk);
    }
    grid.sync();
    const unsigned long long gk = __ldcg(p.keys + slot);
    const float kf = key_fit(gk);
    if (gk != 0ull && kf > gf) {
      gf = kf;
      const float* c =
          p.cand + ((size_t)slot * gridDim.x + key_index(gk) / p.bn) * D;
      for (int k = tid; k < D; k += nt) sm[k] = __ldcg(c + k);
    }
    if (tid == 0) s_key = 0ull;
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int k = tid; k < D; k += nt) p.gp[k] = sm[k];
    if (tid == 0) *p.gf = gf;
  }
}

// ---------------------------------------------------------------------------
// Async queue-lock: a normal launch, one CTA per particle block, resident
// for its whole span. Each chunk runs `chunk` iterations against the block's
// local best in shared memory; the shared gbest (fit + D floats, which no
// single atomic covers) is touched only at chunk boundaries.
//
// At a boundary a CTA publishes its local best if it beats gbest, otherwise
// pulls gbest if it beats the local best — the TPU kernel's chunk-exit
// publish followed by the next chunk's entry pull. The order of
// publications across CTAs is a race by design; with one block the kernel
// equals the fused kernel for every chunk length.
//
// The shared gbest is guarded by the paper's lock plus a sequence counter
// (lock[0] mutex, lock[1] sequence; a seqlock). Writers take the atomicCAS
// spin lock (thread 0), make the sequence odd, copy with the whole CTA
// between __syncthreads, __threadfence, make it even and release. Readers
// take no lock: they read the sequence, the fitness and the D floats, and
// retry if the sequence was odd or moved. All reads of the shared gbest
// bypass L1 (__ldcg), which is not coherent across SMs.
//
// Why not a lock for every boundary: all CTAs reach a boundary at about the
// same time, so with a lock around every read 256 CTAs serialise their
// critical sections at every boundary (chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W: 58 us an iteration at n=131072, d=1, sync_every=8, against
// 3 us with the reads taken off the lock). The decision to publish needs
// only the fitness, read without the lock; gbest only grows, so a CTA that
// sees gbest >= its local best would also lose under the lock. It then
// takes the lock, checks again, and writes. At steady state improvements
// are rare and a boundary costs one L2 read.
// ---------------------------------------------------------------------------
enum BoundaryAct { kNone = 0, kPublish = 1, kPull = 2 };

__device__ __forceinline__ float boundary(const Params& p, float* att, float lf,
                                          bool publish, bool pull,
                                          float* s_g, int* s_act) {
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned* mutex = p.lock;
  unsigned* seq = p.lock + 1;
  if (tid == 0) {
    const float g = __ldcg(p.gf);
    *s_act = (publish && lf > g) ? kPublish : ((pull && g > lf) ? kPull : kNone);
  }
  __syncthreads();
  int act = *s_act;
  if (act == kPublish) {
    if (tid == 0) {
      while (atomicCAS(mutex, 0u, 1u) != 0u) __nanosleep(64);
      __threadfence();
      const float g = __ldcg(p.gf);
      const bool win = lf > g;
      if (win) {
        atomicAdd(seq, 1u);                 // odd: a write is in flight
        __threadfence();
      }
      *s_act = win ? kPublish : ((pull && g > lf) ? kPull : kNone);
    }
    __syncthreads();
    act = *s_act;
    if (act == kPublish)
      for (int k = tid; k < p.d; k += nt) __stcg(p.gp + k, att[k]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      if (act == kPublish) {
        __stcg(p.gf, lf);
        __threadfence();
        atomicAdd(seq, 1u);                 // even: the write is complete
      }
      __threadfence();
      atomicExch(mutex, 0u);
    }
  }
  if (act == kPull) {
    for (;;) {
      if (tid == 0) {
        unsigned s1;
        while ((s1 = __ldcg(seq)) & 1u) __nanosleep(32);
        __threadfence();
        *s_g = __ldcg(p.gf);
        s_act[1] = (int)s1;
      }
      __syncthreads();
      for (int k = tid; k < p.d; k += nt) att[k] = __ldcg(p.gp + k);
      __threadfence();
      __syncthreads();
      if (tid == 0) s_act[2] = __ldcg(seq) != (unsigned)s_act[1];
      __syncthreads();
      const bool torn = s_act[2];
      __syncthreads();              // every thread has read the torn flag
      if (!torn) break;
    }
    lf = *s_g;                      // gbest only grows: still > lf
  }
  return lf;
}

// The (512, 2) bound caps the async kernel at 64 registers, as the fused
// one. Its normal launch does not need every CTA resident, but the cap
// measured faster on the main path's d=120 swarm: cubic d=120 n=32768
// async ran 54.96 and 56.43 us an iteration with it against 67.38 and 68.40
// without (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, one call, runs in
// the order with, without, without, with); at d=1 the two were within the
// runs' spread.
template <int F, int R>
__global__ void __launch_bounds__(kMaxThreads, 2) async_kernel(Params p) {
  extern __shared__ float sm[];
  __shared__ unsigned long long s_key[2];
  __shared__ float s_gf;
  __shared__ int s_act[3];
  const int D = p.d, tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, nb = gridDim.x;
  load_bounds(p, sm);
  for (int k = tid; k < D; k += nt) sm[k] = p.lp[(size_t)k * nb + b];
  if (tid == 0) s_key[0] = s_key[1] = 0ull;
  float lf = p.lf[b];
  __syncthreads();
  const int chunks = p.iters / p.chunk;
  int par = 0;
  for (int c = 0; c <= chunks; ++c) {
    lf = boundary(p, sm, lf, c > 0, c < chunks, &s_gf, s_act);
    if (c == chunks) break;
    for (int tl = 0; tl < p.chunk; ++tl) {
      const uint32_t it = p.it0 + (uint32_t)(c * p.chunk + tl) + 1u;
      const unsigned long long mine = step_block<F, R>(p, it, sm, lf);
      if (mine) atomicMax(&s_key[par], mine);
      __syncthreads();
      // s_key[par ^ 1] was last read before the barrier above; clearing it
      // here keeps every clear ahead of the next iteration's atomicMax.
      const unsigned long long bk = s_key[par];
      if (tid == 0) s_key[par ^ 1] = 0ull;
      if (bk) {     // every candidate beats lf, so the block's best is taken
        lf = key_fit(bk);
        const int wi = key_index(bk);
        for (int k = tid; k < D; k += nt) sm[k] = p.pos[(size_t)k * p.n + wi];
      }
      __syncthreads();
      par ^= 1;
    }
  }
  for (int k = tid; k < D; k += nt) p.lp[(size_t)k * nb + b] = sm[k];
  if (tid == 0) p.lf[b] = lf;
}

using Kernel = void (*)(Params);

#define PSO_ROW(K, F) {K<F, 0>, K<F, 1>, K<F, 2>}
#define PSO_TABLE(K)                                                        \
  {PSO_ROW(K, 0), PSO_ROW(K, 1), PSO_ROW(K, 2), PSO_ROW(K, 3), PSO_ROW(K, 4), \
   PSO_ROW(K, 5)}

const Kernel kFused[kFitnessCount][kRuleCount] = PSO_TABLE(fused_kernel);
const Kernel kAsync[kFitnessCount][kRuleCount] = PSO_TABLE(async_kernel);

Kernel pick(const Kernel (*table)[kRuleCount], int fit, int rule) {
  if (fit < 0 || fit >= kFitnessCount || rule < 0 || rule >= kRuleCount)
    return nullptr;
  return table[fit][rule];
}

size_t smem_bytes(int d) { return (size_t)5 * d * sizeof(float); }

cudaError_t prepare(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

Params make_params(float* pos, float* vel, float* pbp, float* pbf, float* gp,
                   float* gf, const float* bounds, int n, int d, int bn,
                   int iters, unsigned seed, unsigned it0, float w, float c1,
                   float c2, float k0, float k1, float k2) {
  Params p = {};
  p.pos = pos; p.vel = vel; p.pbp = pbp; p.pbf = pbf; p.gp = gp; p.gf = gf;
  p.bounds = bounds;
  p.n = n; p.d = d; p.bn = bn; p.iters = iters; p.chunk = iters;
  p.seed = seed; p.it0 = it0;
  p.w = w; p.c1 = c1; p.c2 = c2; p.k0 = k0; p.k1 = k1; p.k2 = k2;
  return p;
}

int threads_for(int bn) { return bn < kMaxThreads ? bn : kMaxThreads; }

}  // namespace

extern "C" {

// How many fused-kernel CTAs of this configuration can be resident at once
// (occupancy per SM x SM count): the cooperative launch needs all n/bn.
int pso_fused_resident_ctas(int fit, int rule, int bn, int d, int* out) {
  const Kernel k = pick(kFused, fit, rule);
  if (!k) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = prepare(k, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                        threads_for(bn), smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)err;
}

int pso_fused_launch(float* pos, float* vel, float* pbp, float* pbf, float* gp,
                     float* gf, const float* bounds, unsigned long long* keys,
                     float* cand, int n, int d, int bn, int iters,
                     unsigned seed, unsigned it0, int fit, int rule, float w,
                     float c1, float c2, float k0, float k1, float k2,
                     void* stream) {
  const Kernel k = pick(kFused, fit, rule);
  if (!k || bn <= 0 || n % bn) return (int)cudaErrorInvalidValue;
  Params p = make_params(pos, vel, pbp, pbf, gp, gf, bounds, n, d, bn, iters,
                         seed, it0, w, c1, c2, k0, k1, k2);
  p.keys = keys;
  p.cand = cand;
  const size_t smem = smem_bytes(d);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)k, dim3(n / bn),
                                    dim3(threads_for(bn)), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int pso_async_launch(float* pos, float* vel, float* pbp, float* pbf, float* gp,
                     float* gf, const float* bounds, float* lp, float* lf,
                     unsigned* lock, int n, int d, int bn, int iters, int chunk,
                     unsigned seed, unsigned it0, int fit, int rule, float w,
                     float c1, float c2, float k0, float k1, float k2,
                     void* stream) {
  const Kernel k = pick(kAsync, fit, rule);
  if (!k || bn <= 0 || n % bn || chunk <= 0 || iters % chunk)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(pos, vel, pbp, pbf, gp, gf, bounds, n, d, bn, iters,
                         seed, it0, w, c1, c2, k0, k1, k2);
  p.lp = lp;
  p.lf = lf;
  p.lock = lock;
  p.chunk = chunk;
  const size_t smem = smem_bytes(d);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<n / bn, threads_for(bn), smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
