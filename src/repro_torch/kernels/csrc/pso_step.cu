// Hand-written Hopper (sm_90a) kernels for cuPSO.
//
// Three kernels port the seven Pallas TPU kernels of
// src/repro/kernels/pso_step.py, written from what those kernels compute:
//
//   queue_kernel  one iteration of the paper's queue algorithm (§4.1) for
//                 one swarm: gbest read-only, one (fitness, index) pair per
//                 particle block out. Replaces queue_step_call (body
//                 _make_sync_kernel(queue=True)); the cross-block argmax is
//                 the caller's epilogue, as in the reference.
//   fused_kernel  `iters` iterations of the fused queue-lock (paper §4.2)
//                 for S independent swarms. Replaces fused_call (S = 1),
//                 fused_batch_call and hetero_fused_batch_call (bodies
//                 _make_sync_kernel()).
//   async_kernel  the paper's enhanced asynchronous queue-lock for S
//                 swarms. Replaces fused_async_call (S = 1),
//                 fused_async_batch_call and hetero_fused_async_batch_call
//                 (bodies _make_async_kernel(), chunk loop _async_chunk_body),
//                 with every `topology` they take: the star (gbest) and,
//                 as instantiations of their own (LB), the lbest ring and
//                 von Neumann neighbour folds.
//
// fused_kernel and async_kernel also replace the TPU kernels' telemetry
// variants (_make_sync_kernel(telemetry=True), _make_async_kernel(
// telemetry=True)): given a counter buffer they add each swarm's
// contention events into it (below, "Contention counters").
//
// Layout: D-major, arrays [D, S*N] with the particle index fastest (§5.1
// coalescing rule); swarm s owns columns [s*N, (s+1)*N), and its gbest is
// column s of gp [D, S]. A particle block of one swarm (bn <= 512 particles
// at the main shapes; core/blocking.py) runs on a cluster of C CTAs, C at
// most 8 and chosen by the wrapper from (N, D, bn) and the card alone
// (kernels/pso_step.py cluster_size). CTA rank r of the cluster owns the
// dimensions [r*D/C, (r+1)*D/C) of all bn particles (slices differ by one
// when C does not divide D) and keeps only its slice of the attractor and
// of the bounds in shared memory. Thread l works on particle base + l in
// every CTA of the cluster, so neighbouring threads touch neighbouring
// addresses of every dimension. Each thread walks its slice and keeps the
// slice's partial objective (this replaces the TPU kernel's masked sublane
// sums); the C partials of a particle meet in distributed shared memory
// (below). With C = 1 the CTA is the whole block, thread l also takes
// particles base + l + blockDim, ..., and there is no cluster code at all.
// Every swarm has its own RNG seed and iteration counter (seeds[S],
// its[S]), and RNG element indices are local to the swarm, so a swarm's row
// of a batch draws what the swarm draws alone.
//
// Storage type: every kernel template takes the type T of the swarm's
// arrays (below, "Storage types"): float, or __nv_bfloat16 in the library
// built from this source with -DPSO_T_BF16. One library holds one type's
// kernels; kernels/pso_step.py loads the one a swarm's dtype needs. The
// bfloat16 library has no heterogeneous kernels, and its queue, fused and
// async kernels come twice: a particle a thread (the lane path), and two a
// thread in packed bfloat16 arithmetic (queue_pair_kernel,
// fused_pair_kernel, async_pair_kernel; below, "the bfloat16 pair
// path").
//
// Heterogeneous batches: bounds are a table [members, 4, D] and fids[S]
// picks a swarm's member (a homogeneous batch is a table of one, read at
// member 0). The objective is a template parameter; the hetero kernels
// (F == kHetero) switch once, at the top of the CTA, on the member's
// objective into the same templated body. A CTA belongs to one swarm, so
// the switch is uniform across the CTA: the CUDA form of the TPU kernel's
// scalar lax.switch.
//
// What bounds them on an H100: per iteration a particle-dimension reads
// pos, vel and pbest_pos and writes pos and vel (20 bytes), so a pass over
// the swarms is S*(20*N*D + 8*N) bytes: at an H100 SXM's 3.35 TB/s (data
// sheet) 1.1 us at N=131072, D=1 (3.7 MB, inside the 50 MB L2) and 23.5 us
// at N=32768, D=120 (78.9 MB, beyond it). Against that each element of the
// cubic/pso path spends 42 integer operations (two counter-hash draws)
// and 24 float ones (the rule, the objective); integers issue at a quarter
// of the data sheet's 67 TFLOP/s, so at D=1 the operations take 0.33 us an
// iteration (chip_smoke.py counts them). At large D neither is what a CTA
// a block would wait on: one thread walking all D dimensions of its
// particle is a chain of D dependent steps, and 64 CTAs of 512 threads at
// N=32768 fill 12% of the card's thread slots, too few loads in flight to
// stream 79 MB. A cluster of C CTAs a block cuts the chain to D/C steps
// and puts C times the threads on the card, while the block, its queue and
// its RNG indices stay the reference's. The fused kernel's cooperative
// launch must hold every cluster at once: at 512 threads an H100 keeps 132
// clusters of 2, 62 of 4 and 30 of 8 resident (chip_smoke.py phase 5b),
// so N=32768's 64 blocks take clusters of 2. The async kernel takes the
// same C at every shape: a cluster of its normal launch holds its SMs for
// its whole span, so one that does not fit waits out another's span, and
// with one block it must equal the fused kernel bit for bit, which only
// the same C (the same order of the partial sums) gives. At small D the
// fused kernel
// is bound by the grid-wide synchronisation of every iteration. The
// design keeps the whole iteration loop inside one launch (no
// per-iteration launch latency), keeps the attractor and the bounds in
// shared memory, and publishes one 64-bit key per block only when the
// block has a candidate (the paper's rare-improvement predicate). The
// queue kernel is the algorithm that design improves on: one iteration a
// launch, its work per element the same, plus a launch and its caller's
// epilogue every iteration.
//
// A particle's fitness across a cluster: each rank writes its partial
// objective state (the sum, plus griewank's product, ackley's second sum,
// rosenbrock's first and last coordinate of the slice) to its own shared
// memory, double-buffered by iteration parity; one cluster.sync(); then
// every rank reads all C partials of its particles over DSMEM and combines
// them in rank order (rosenbrock's pair across a slice boundary from the
// neighbour's last coordinate, passed with the partials rather than read
// back from pos). Every rank so holds the same fitness bit for bit, folds
// pbest on its own slice of the column (rank 0 alone writes pbf), and
// raises its own copy of the block key with atomicMax: identical keys, no
// remote atomics, no second sync. Only the order of the objective's sum
// differs from C = 1; positions stay bit-equal.
//
// Arithmetic uses the __f*_rn intrinsics so that nvcc does not contract
// into FMAs: the kernels then round exactly as the plain PyTorch versions
// (kernels/pso_step.py) do, which is what chip_smoke.py holds them to.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kFitnessCount = 6;   // core/fitness.py FITNESS_IDS order
constexpr int kHetero = kFitnessCount;   // objective read per swarm
constexpr int kRuleCount = 3;      // core/update_rules.py RULE_IDS order
constexpr uint32_t kStreamR1 = 2u, kStreamR2 = 3u;
constexpr int kBatch = 4;          // dimensions loaded together

// ---- storage types ---------------------------------------------------------
// The swarm's arrays (pos, vel, pbest, the bests, the async locals, the
// fused kernel's candidate columns and the queue kernel's aux_fit) are of
// type T; the bounds table and shared memory are float in both libraries.
// A value is widened to float when it is loaded and narrowed when it is
// stored. In bfloat16 the kernels compute what the reference's kernels
// compute in that dtype (ROADMAP, parity contract, "bfloat16"): every
// operation's result is rounded to bfloat16 (q<T>), each constant is the
// bfloat16 value of the reference's weak-typed Python float (kc<T>), and
// an objective's sum over D adds its rounded terms in float, in dimension
// order, and is rounded once. For float, q<T>, widen and narrow are the
// identity, so the float kernels compute what they computed before T was a
// parameter.
#ifdef PSO_T_BF16
using Store = __nv_bfloat16;
#else
using Store = float;
#endif

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __float2bfloat16_rn(x);
}
// x rounded to T (to nearest even) and widened again.
template <typename T>
__device__ __forceinline__ float q(float x) {
  return widen(narrow<T>(x));
}
// A constant: its float value f, or b, the same Python float rounded to
// bfloat16.
template <typename T>
__device__ __forceinline__ constexpr float kc(float f, float b) {
  return std::is_same<T, float>::value ? f : b;
}
// Loads and stores past L1 (the async kernel's shared gbest and slots).
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
  return widen(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void stcg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void stcg(__nv_bfloat16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <typename T>
struct Params {
  T* pos; T* vel; T* pbp; T* pbf;                    // [D,S*N] x3, [S*N]
  T* gp; T* gf;                                      // [D,S], [S]
  const float* bounds;       // [members,4,D]: lo, hi, max_v, span
  const int* member_fit;     // hetero: [members] objective ids
  const int* fids;           // hetero: [S] member of each swarm, else null
  const unsigned* seeds;     // [S] RNG seeds, or null: seed0
  const unsigned* its;       // [S] iteration counters before the launch,
                             // or null: it00
  T* lp; T* lf;                                      // async: [D,S*nb], [S*nb]
  unsigned long long* keys;                          // fused: [S,2] winner keys
  T* cand;                                           // fused: [2,S*nb,D]
  unsigned* lock;                                    // async: [S,2]
  T* aux_fit; int* aux_idx;                          // queue: [nb], [nb]
  int* counts;               // fused/async: [S,3] event counts, or null
  int n, d, bn, nb, s_cnt, s0, iters, chunk;
  int csize;                 // CTAs in a particle block's cluster
  int ld;                    // row stride of the [D, S*N] arrays: S*N
  uint32_t it_off;           // added to its[] (the async remainder phase)
  uint32_t seed0, it00;      // a single swarm's counters, passed by value
  float w, c1, c2, k0, k1, k2;   // values of T (the caller rounds them)
  // async under an lbest topology: [S*nb] per-slot sequence counters of
  // lp/lf, the topology (kRing, kVonNeumann) and the von Neumann grid
  unsigned* slot_seq;
  int topo, grid_r, grid_c;
};

// Where a CTA works: swarm s (of the whole batch; a wave of the fused
// kernel starts at s0), particle block b of that swarm, and with a cluster
// (CL) its rank and slice of the dimensions. Columns are 32-bit (the
// wrapper keeps S*N below 2^31); an element's offset k*ld + column is
// formed in 64 bits from the parameter ld, as for a single swarm, which
// keeps the per-element index math and its registers at the single-swarm
// kernel's.
struct Cta {
  int s, b, member;
  uint32_t seed, it0;
  int col;         // first column of the swarm in the [D, S*N] arrays
  int rank;        // in the cluster; 0 without one
  int k0, k1, ls;  // the CTA's dimensions [k0, k1); ls: its shared row length
};

template <bool CL, typename T>
__device__ __forceinline__ Cta cta_of(const Params<T>& p) {
  Cta c;
  // A 1-D cluster is C consecutive CTAs: blockIdx.x / C is the block.
  const int blk = CL ? (int)blockIdx.x / p.csize : (int)blockIdx.x;
  c.s = p.s0 + blk / p.nb;
  c.b = blk % p.nb;
  c.member = p.fids ? p.fids[c.s] : 0;
  c.seed = p.seeds ? p.seeds[c.s] : p.seed0;
  c.it0 = (p.its ? p.its[c.s] : p.it00) + p.it_off;
  c.col = c.s * p.n;
  if constexpr (CL) {
    c.rank = (int)cg::this_cluster().block_rank();
    c.k0 = c.rank * p.d / p.csize;
    c.k1 = (c.rank + 1) * p.d / p.csize;
    c.ls = (p.d + p.csize - 1) / p.csize;
  } else {
    c.rank = 0;
    c.k0 = 0;
    c.k1 = c.ls = p.d;
  }
  return c;
}

// ---- counter hash: repro/core/rng.py, bit for bit --------------------------
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u; x ^= x >> 16;
  return x;
}

// In bfloat16 the 24 bits are rounded to bfloat16 (to nearest even) before
// the exact scaling, as the reference's (h >> 8).astype(dtype) * 2**-24:
// the draw may then be 1.0.
template <typename T>
__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t it,
                                           uint32_t stream, uint32_t idx) {
  uint32_t h = seed * 0x9E3779B9u + it * 0x85EBCA6Bu + stream * 0xC2B2AE35u +
               idx * 0x27D4EB2Fu;
  h = mix32(h);
  h = mix32(h ^ (idx * 0x9E3779B9u + it * 0xC2B2AE35u));
  return __fmul_rn(q<T>((float)(h >> 8)), 1.0f / 16777216.0f);
}

// ---- the three update rules (core/update_rules.py) ------------------------
// Each operation rounds to T (q<T>, the identity for float).
template <int R, typename T>
__device__ __forceinline__ void advance(const Params<T>& p, float r1,
                                        float r2, float& x, float& v,
                                        float pb, float g, float lo, float hi,
                                        float mv, float span) {
  if (R == 0) {          // pso: v = w v + c1 r1 (pb - x) + c2 r2 (g - x)
    const float a = q<T>(__fmul_rn(p.w, v));
    const float b = q<T>(__fmul_rn(q<T>(__fmul_rn(p.c1, r1)),
                                   q<T>(__fsub_rn(pb, x))));
    const float c = q<T>(__fmul_rn(q<T>(__fmul_rn(p.c2, r2)),
                                   q<T>(__fsub_rn(g, x))));
    v = fminf(fmaxf(q<T>(__fadd_rn(q<T>(__fadd_rn(a, b)), c)), -mv), mv);
    x = fminf(fmaxf(q<T>(__fadd_rn(x, v)), lo), hi);
  } else if (R == 1) {   // sso: copy from gbest / pbest / keep / resample
    const float fresh = q<T>(__fadd_rn(lo, q<T>(__fmul_rn(span, r2))));
    x = r1 < p.k0 ? g : (r1 < p.k1 ? pb : (r1 < p.k2 ? x : fresh));
    x = fminf(fmaxf(x, lo), hi);
  } else {               // lowcost: Bernoulli-selected difference terms
    const float a = r1 < 0.5f ? q<T>(__fsub_rn(pb, x)) : 0.0f;
    const float b = r2 < 0.5f ? q<T>(__fsub_rn(g, x)) : 0.0f;
    v = fminf(fmaxf(q<T>(__fadd_rn(q<T>(__fadd_rn(v, a)), b)), -mv), mv);
    x = fminf(fmaxf(q<T>(__fadd_rn(x, v)), lo), hi);
  }
}

// ---- the six objectives (core/fitness.py), one streaming pass over D -------
// In bfloat16 the terms and the result follow the reference's kernel forms
// (repro/kernels/pso_step.py _fitness_dmajor) rounding by rounding: each
// term rounded, the sum over D in float, rounded once (jnp.sum's float32
// accumulation). Griewank's product there is float32 (its dimension index
// is a float32 column), so it stays float here and the fitness is rounded
// once, at the end.
constexpr float kTwoPi = 6.283185307179586f;

template <typename T, int F>
struct Objective {
  float s = 0.0f, t = 0.0f, prev = 0.0f;
  float p = 1.0f;
  float first = 0.0f;    // rosenbrock: the slice's first coordinate

  // Dimension k of a walk that starts at dimension k0 (0 without a split).
  __device__ __forceinline__ void add(int k, int k0, float x) {
    const float xx = q<T>(__fmul_rn(x, x));
    if (F == 0) {          // cubic: x^3 - 0.8 x^2 - 1000 x + 8000
      const float v = q<T>(__fadd_rn(
          q<T>(__fsub_rn(q<T>(__fsub_rn(q<T>(__fmul_rn(xx, x)),
                                        q<T>(__fmul_rn(kc<T>(0.8f,
                                                             0.80078125f),
                                                       xx)))),
                         q<T>(__fmul_rn(1000.0f, x)))),
          8000.0f));
      s = __fadd_rn(s, v);
    } else if (F == 1) {   // sphere
      s = __fadd_rn(s, xx);
    } else if (F == 2) {   // rosenbrock: pairs (prev, x); D == 1 uses t
      if (k > k0) {
        s = __fadd_rn(s, pair(prev, x));
      } else {
        const float u = q<T>(__fsub_rn(1.0f, x));
        t = q<T>(__fmul_rn(u, u));
        first = x;
      }
      prev = x;
    } else if (F == 3) {   // griewank
      s = __fadd_rn(s, xx);
      p = __fmul_rn(p, cosf(__fdiv_rn(x, sqrtf((float)(k + 1)))));
    } else if (F == 4) {   // rastrigin
      const float c = q<T>(cosf(q<T>(__fmul_rn(kc<T>(kTwoPi, 6.28125f), x))));
      s = __fadd_rn(s, q<T>(__fsub_rn(xx, q<T>(__fmul_rn(10.0f, c)))));
    } else {               // ackley
      s = __fadd_rn(s, xx);
      t = __fadd_rn(t, q<T>(cosf(q<T>(__fmul_rn(kc<T>(kTwoPi, 6.28125f),
                                                  x)))));
    }
  }

  // float: 100 (u u) + (1 - a)^2; bfloat16 as the reference's kernel:
  // (100 u) u + (1 - a)^2, each operation rounded.
  static __device__ __forceinline__ float pair(float a, float x) {
    const float u = q<T>(__fsub_rn(x, q<T>(__fmul_rn(a, a))));
    const float r = q<T>(__fsub_rn(1.0f, a));
    if constexpr (std::is_same<T, float>::value)
      return __fadd_rn(__fmul_rn(100.0f, __fmul_rn(u, u)), __fmul_rn(r, r));
    else
      return q<T>(__fadd_rn(q<T>(__fmul_rn(q<T>(__fmul_rn(100.0f, u)), u)),
                            q<T>(__fmul_rn(r, r))));
  }

  // Appends the partial state of the next slice (rank order): the sums add,
  // griewank's products multiply, and rosenbrock gains the pair that
  // crosses the boundary.
  __device__ __forceinline__ void join(const Objective& o) {
    if (F == 2) {
      s = __fadd_rn(__fadd_rn(s, pair(prev, o.first)), o.s);
      prev = o.prev;
    } else {
      s = __fadd_rn(s, o.s);
    }
    if (F == 3) p = __fmul_rn(p, o.p);
    if (F == 5) t = __fadd_rn(t, o.t);
  }

  // The partial state of particle l in a [3][n] shared buffer: the sum,
  // then the fields this objective carries besides it.
  __device__ __forceinline__ void put(float* b, int l, int n) const {
    b[l] = s;
    if (F == 2) { b[n + l] = first; b[2 * n + l] = prev; }
    if (F == 3) b[n + l] = p;
    if (F == 5) b[n + l] = t;
  }
  static __device__ __forceinline__ Objective take(const float* b, int l,
                                                   int n) {
    Objective o;
    o.s = b[l];
    if (F == 2) { o.first = b[n + l]; o.prev = b[2 * n + l]; }
    if (F == 3) o.p = b[n + l];
    if (F == 5) o.t = b[n + l];
    return o;
  }

  __device__ __forceinline__ float result(int d) const {
    const float sum = q<T>(s);
    if (F == 0) return sum;
    if (F == 1) return -sum;
    if (F == 2) return d == 1 ? -t : -sum;
    if (F == 3)
      return q<T>(-__fadd_rn(__fsub_rn(q<T>(__fdiv_rn(sum, 4000.0f)), p),
                             1.0f));
    if (F == 4) return -q<T>(__fadd_rn(q<T>((float)(10.0 * d)), sum));
    const float fd = q<T>((float)d);
    const float e1 = q<T>(expf(q<T>(__fmul_rn(
        kc<T>(-0.2f, -0.2001953125f), q<T>(sqrtf(q<T>(__fdiv_rn(sum,
                                                                 fd))))))));
    const float e2 = q<T>(expf(q<T>(__fdiv_rn(q<T>(t), fd))));
    return -q<T>(__fadd_rn(
        q<T>(__fadd_rn(q<T>(__fsub_rn(q<T>(__fmul_rn(-20.0f, e1)), e2)),
                       20.0f)),
        kc<T>(2.718281828459045f, 2.71875f)));
  }
};

// Advances particle i (local to the swarm) on the CTA's dimensions
// [k0, k1) against the attractor in shared memory (att, then the lo, hi,
// max_v and span rows, each ls long, indexed from k0), writes pos and vel,
// and returns the objective's state over those dimensions. Without a
// cluster the range is all of D.
template <typename T, int F, int R, bool CL>
__device__ __forceinline__ Objective<T, F> advance_particle(
    const Params<T>& p, const Cta& c, int i, uint32_t it, const float* sm) {
  const int D = p.d;
  const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : D, ls = CL ? c.ls : D;
  const float* att = sm;
  const float* lo = sm + ls;
  const float* hi = sm + 2 * ls;
  const float* mv = sm + 3 * ls;
  const float* span = sm + 4 * ls;
  Objective<T, F> obj;
  const uint32_t idx0 = (uint32_t)i * (uint32_t)D;   // index = particle*D + dim
  const int col = c.col + i;
  auto update = [&](int k, float x, float v, float pb) {
    const size_t o = (size_t)k * p.ld + col;
    const float r1 = uniform01<T>(c.seed, it, kStreamR1, idx0 + (uint32_t)k);
    const float r2 = uniform01<T>(c.seed, it, kStreamR2, idx0 + (uint32_t)k);
    const int j = k - k0;
    advance<R>(p, r1, r2, x, v, pb, att[j], lo[j], hi[j], mv[j], span[j]);
    p.pos[o] = narrow<T>(x);
    p.vel[o] = narrow<T>(v);
    obj.add(k, k0, x);
  };
  // One thread walks its dimensions of its particle, so the loads of
  // kBatch dimensions are issued together before any of them is used;
  // otherwise every dimension waits out a memory latency in turn. The
  // remainder (all of the range when it is shorter than kBatch) takes one
  // dimension at a time.
  int k = k0;
  for (; k + kBatch <= k1; k += kBatch) {
    float x[kBatch], v[kBatch], pb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t o = (size_t)(k + j) * p.ld + col;
      x[j] = widen(p.pos[o]);
      v[j] = widen(p.vel[o]);
      pb[j] = widen(p.pbp[o]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) update(k + j, x[j], v[j], pb[j]);
  }
  for (; k < k1; ++k) {
    const size_t o = (size_t)k * p.ld + col;
    update(k, widen(p.pos[o]), widen(p.vel[o]), widen(p.pbp[o]));
  }
  return obj;
}

// One iteration of particle i on all D dimensions (no cluster): advance,
// objective, pbest fold. Returns the fitness. With counters (TL and
// p.counts) an improvement also raises the CTA's flag s_cnt[3].
template <typename T, int F, int R, bool TL>
__device__ __forceinline__ float step_particle(const Params<T>& p,
                                               const Cta& c, int i,
                                               uint32_t it, const float* sm,
                                               int* s_cnt) {
  const int D = p.d;
  const int col = c.col + i;
  const float f =
      advance_particle<T, F, R, false>(p, c, i, it, sm).result(D);
  if (f > widen(p.pbf[col])) {  // rare at steady state: copy the column
    if (TL && p.counts) s_cnt[3] = 1;
    p.pbf[col] = narrow<T>(f);
    for (int j = 0; j < D; ++j) {
      const size_t o = (size_t)j * p.ld + col;
      p.pbp[o] = p.pos[o];
    }
  }
  return f;
}

// Queue keys: (order-preserving fitness bits) << 32 | (0xFFFFFFFF - index),
// the index local to the swarm. A larger key is a higher fitness, and on
// equal fitness the lower particle index: one 64-bit atomicMax is the
// queue's scan with the reference's first-lane tie-break
// (pso_step._queue_best).
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

// Shared memory: the attractor's row, then the swarm's member's lo, hi,
// max_v, span rows, each ls long and holding the CTA's dimensions
// [k0, k1) (all of D without a cluster); with a cluster, the partial
// objectives after them (partials()). `src` is the attractor: a D-major
// array with row stride `stride`, read at column `colm`.
template <bool CL, typename T>
__device__ __forceinline__ void load_rows(const Params<T>& p, const Cta& c,
                                          float* sm, const T* src,
                                          size_t stride, size_t colm) {
  const float* b = p.bounds + (size_t)c.member * 4 * p.d;
  if constexpr (!CL) {
    for (int k = threadIdx.x; k < 4 * p.d; k += blockDim.x) sm[p.d + k] = b[k];
  } else {
    const int len = c.k1 - c.k0;
    for (int e = threadIdx.x; e < 4 * len; e += blockDim.x) {
      const int j = e / len, k = e - j * len;
      sm[c.ls * (j + 1) + k] = b[j * p.d + c.k0 + k];
    }
  }
  for (int k = c.k0 + (int)threadIdx.x; k < c.k1; k += blockDim.x)
    sm[k - c.k0] = widen(src[(size_t)k * stride + colm]);
}

// A cluster CTA's partial-objective buffers: [2 parities][3][bn] floats.
__device__ __forceinline__ float* partials(const Cta& c, float* sm) {
  return sm + 5 * c.ls;
}

// Each thread's particles: one pass, returning the thread's best queue key
// (0 when none of its particles beats `best`). TL: count improvements into
// s_cnt (step_particle).
template <typename T, int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_block(const Params<T>& p,
                                                         const Cta& c,
                                                         uint32_t it,
                                                         const float* sm,
                                                         float best,
                                                         int* s_cnt) {
  unsigned long long mine = 0ull;
  const int base = c.b * p.bn;
  for (int l = threadIdx.x; l < p.bn; l += blockDim.x) {
    const int i = base + l;
    const float f = step_particle<T, F, R, TL>(p, c, i, it, sm, s_cnt);
    if (f > best) {
      const unsigned long long key = make_key(f, i);
      mine = key > mine ? key : mine;
    }
  }
  return mine;
}

// The same pass on a cluster: thread l is particle base + l of the block
// (blockDim == bn) on the CTA's dimensions. The partial objectives go to
// `part` (this iteration's parity); after one cluster.sync() every rank
// reads the C partials of its particle from ranks 0, 1, ..., C-1 in that
// order, so all ranks hold the same fitness bit for bit. `pbf` is the
// particle's pbest fitness, kept in a register by every rank (rank 0 alone
// stores it): a rank that read it from memory could see rank 0's store of
// this same iteration. Returns the thread's queue key (0 when its
// particle does not beat `best`). TL as in step_block: every rank takes the
// same pbest decision, so every rank's flag agrees.
template <typename T, int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_cluster(
    const Params<T>& p, const Cta& c, uint32_t it, const float* sm,
    float best, float* part, float& pbf, int* s_cnt) {
  using Obj = Objective<T, F>;
  const cg::cluster_group cl = cg::this_cluster();
  const int l = threadIdx.x, i = c.b * p.bn + l, col = c.col + i;
  advance_particle<T, F, R, true>(p, c, i, it, sm).put(part, l, p.bn);
  cl.sync();
  Obj obj = Obj::take(cl.map_shared_rank(part, 0), l, p.bn);
  for (int r = 1; r < p.csize; ++r)
    obj.join(Obj::take(cl.map_shared_rank(part, r), l, p.bn));
  const float f = obj.result(p.d);
  if (f > pbf) {               // rare at steady state: copy the slice
    if (TL && p.counts) s_cnt[3] = 1;
    pbf = f;
    if (c.rank == 0) p.pbf[col] = narrow<T>(f);
    for (int k = c.k0; k < c.k1; ++k) {
      const size_t o = (size_t)k * p.ld + col;
      p.pbp[o] = p.pos[o];
    }
  }
  return f > best ? make_key(f, i) : 0ull;
}

// The particles a thread of the fused and async kernels takes: P = 1, one
// (step_block, step_cluster; every library), or P = 2, a pair (the
// bfloat16 library's pair path, step_pairs and step_pairs_cluster below).
// Pbf<P> is a cluster rank's copy of its particles' pbest fitnesses, kept
// in registers (step_cluster).
template <int P>
using Pbf = typename std::conditional<P == 2, float2, float>::type;

template <int P, typename T>
__device__ __forceinline__ Pbf<P> load_pbf(const Params<T>& p,
                                           const Cta& c) {
  const int i = c.col + c.b * p.bn + P * (int)threadIdx.x;
  if constexpr (P == 2)
    return make_float2(widen(p.pbf[i]), widen(p.pbf[i + 1]));
  else
    return widen(p.pbf[i]);
}

template <int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_pairs(
    const Params<__nv_bfloat16>& p, const Cta& c, uint32_t it,
    const float* sm, float best, int* s_cnt);
template <int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_pairs_cluster(
    const Params<__nv_bfloat16>& p, const Cta& c, uint32_t it,
    const float* sm, float best, float* part, float2& pbf, int* s_cnt);

template <typename T, int F, int R, bool TL, int P>
__device__ __forceinline__ unsigned long long step_any(
    const Params<T>& p, const Cta& c, uint32_t it, const float* sm,
    float best, int* s_cnt) {
  if constexpr (P == 2)
    return step_pairs<F, R, TL>(p, c, it, sm, best, s_cnt);
  else
    return step_block<T, F, R, TL>(p, c, it, sm, best, s_cnt);
}

template <typename T, int F, int R, bool TL, int P>
__device__ __forceinline__ unsigned long long step_any_cluster(
    const Params<T>& p, const Cta& c, uint32_t it, const float* sm,
    float best, float* part, Pbf<P>& pbf, int* s_cnt) {
  if constexpr (P == 2)
    return step_pairs_cluster<F, R, TL>(p, c, it, sm, best, part, pbf,
                                        s_cnt);
  else
    return step_cluster<T, F, R, TL>(p, c, it, sm, best, part, pbf, s_cnt);
}

#ifdef PSO_T_BF16
// ---- the bfloat16 pair path ------------------------------------------------
// What bounds the fused and async kernels' element path in each dtype. In
// float an element moves 20 bytes (23.5 us a pass at N=32768, D=120)
// against ~42 integer operations (the two counter-hash draws) and ~24
// float ones (the rule, the objective), so bytes bound it. In bfloat16 it
// moves 10 bytes (11.7 us at HBM's rate; that swarm's 31.5 MB of state
// even stays in the 50 MB L2), and the lane path (P = 1, the float
// kernel's form) rounds every one of the reference's operations as a
// float operation, a conversion to bfloat16 and one back (q<T>): about 20
// conversions an element at cubic/pso on the conversion pipe (16 a clock
// an SM), a 2-byte access a lane, and the hash's per-swarm terms formed
// for every draw. The conversions then set its time, not the bytes. What
// the pair path does about it:
//   * two particles a thread, 2l and 2l + 1 of the block (particles are
//     the contiguous axis of [D, S*N]): a dimension's pos, vel and
//     pbest_pos are one 4-byte load each and pos and vel one store each
//     (vel neither under the SSO rule, which leaves it as it is), the
//     loads of kPairBatch dimensions issued before the first is used;
//   * the rule (advance2) and every objective term the reference rounds as
//     one multiply, add or subtract on the lane pair in sm_90's packed
//     instructions (bf16x2.cuh): one instruction and one rounding for both
//     particles, no conversion. cosf, sqrtf and the divisions stay float a
//     lane, rounded as before (bpack rounds a pair in one conversion), and
//     the sums over D stay float, in dimension order, rounded once;
//   * the hash's per-swarm, per-iteration terms formed once an iteration
//     (hash_terms), its element terms stepped by a constant a dimension
//     and offset by D constants for the second particle.
// A cluster's partials still meet in rank order, so the pair path computes
// the lane path's results bit for bit (chip_smoke.py 15a; check_bf16_ops
// proves the packed instructions). Pairs need an even block (so an even
// swarm and even columns) and operands on 4 bytes: elsewhere the wrapper
// takes the lane path (kernels/pso_step.py kernel_lanes). The queue
// kernel takes the same pair bodies (queue_pair_kernel).
#include "bf16x2.cuh"

using Bf = __nv_bfloat16;

// Dimensions whose loads a thread of the pair path issues together.
constexpr int kPairBatch = 4;

// The objectives' constants as bfloat16 bits in both lanes: 1, the
// rounded 0.8 (0.80078125), 1000, 8000, 10, 100 and the rounded 2 pi
// (6.28125), the values kc<T> and the float literals give the lane path.
constexpr bf2 kOne2 = 0x3F803F80u, k08x2 = 0x3F4D3F4Du,
              k1000x2 = 0x447A447Au, k8000x2 = 0x45FA45FAu,
              k10x2 = 0x41204120u, k100x2 = 0x42C842C8u,
              k2Pi2 = 0x40C940C9u;

__device__ __forceinline__ bf2 ld2(const Bf* q) {
  return *reinterpret_cast<const bf2*>(q);
}
__device__ __forceinline__ void st2(Bf* q, bf2 v) {
  *reinterpret_cast<bf2*>(q) = v;
}

// uniform01's per-swarm, per-iteration terms: seed*C + it*C + stream*C for
// each of the two streams, and it*C of the second mix.
struct Hash2 {
  uint32_t h1, h2, ts;
};
__device__ __forceinline__ Hash2 hash_terms(uint32_t seed, uint32_t it) {
  const uint32_t hs = seed * 0x9E3779B9u + it * 0x85EBCA6Bu;
  return {hs + kStreamR1 * 0xC2B2AE35u, hs + kStreamR2 * 0xC2B2AE35u,
          it * 0xC2B2AE35u};
}

// Objective<Bf, F>'s state for a lane pair: each term on the pair in
// packed instructions, added in float to each lane's sums in dimension
// order; lane(j) is particle j's state, for put/join/result.
template <int F>
struct Objective2 {
  float s[2] = {0.0f, 0.0f}, t[2] = {0.0f, 0.0f}, pr[2] = {1.0f, 1.0f};
  bf2 prev = 0u, first = 0u, tt = 0u;    // rosenbrock

  static __device__ __forceinline__ void acc(float* a, bf2 v) {
    a[0] = __fadd_rn(a[0], blo(v));
    a[1] = __fadd_rn(a[1], bhi(v));
  }
  // rastrigin's and ackley's cos(2 pi x), each lane's cosf rounded
  static __device__ __forceinline__ bf2 cos2(bf2 x) {
    const bf2 a = bmul(k2Pi2, x);
    return bpack(cosf(blo(a)), cosf(bhi(a)));
  }
  // Objective::pair on the lane pair: (100 u) u + (1 - a)^2
  static __device__ __forceinline__ bf2 pair(bf2 a, bf2 x) {
    const bf2 u = bsub(x, bmul(a, a));
    const bf2 r = bsub(kOne2, a);
    return badd(bmul(bmul(k100x2, u), u), bmul(r, r));
  }

  __device__ __forceinline__ void add(int k, int k0, bf2 x) {
    const bf2 xx = bmul(x, x);
    if (F == 0) {          // cubic
      acc(s, badd(bsub(bsub(bmul(xx, x), bmul(k08x2, xx)),
                       bmul(k1000x2, x)),
                  k8000x2));
    } else if (F == 2) {   // rosenbrock
      if (k > k0) {
        acc(s, pair(prev, x));
      } else {
        const bf2 u = bsub(kOne2, x);
        tt = bmul(u, u);
        first = x;
      }
      prev = x;
    } else if (F == 4) {   // rastrigin
      acc(s, bsub(xx, bmul(k10x2, cos2(x))));
    } else {               // sphere, griewank, ackley
      acc(s, xx);
    }
    if (F == 3) {          // griewank's product, float a lane
      const float r = sqrtf((float)(k + 1));
      pr[0] = __fmul_rn(pr[0], cosf(__fdiv_rn(blo(x), r)));
      pr[1] = __fmul_rn(pr[1], cosf(__fdiv_rn(bhi(x), r)));
    }
    if (F == 5) acc(t, cos2(x));
  }

  __device__ __forceinline__ Objective<Bf, F> lane(int j) const {
    Objective<Bf, F> o;
    o.s = s[j];
    o.t = F == 2 ? (j ? bhi(tt) : blo(tt)) : t[j];
    o.p = pr[j];
    o.prev = j ? bhi(prev) : blo(prev);
    o.first = j ? bhi(first) : blo(first);
    return o;
  }
};

// advance_particle for particles i and i + 1 (i even): the rule and the
// objective on the lane pair over the CTA's dimensions [k0, k1).
template <int F, int R, bool CL>
__device__ __forceinline__ void advance_pair(const Params<Bf>& p,
                                             const Cta& c, int i,
                                             const Hash2& hh,
                                             const float* sm,
                                             Objective2<F>& obj) {
  const int D = p.d;
  const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : D, ls = CL ? c.ls : D;
  const float* att = sm;
  const float* lo = sm + ls;
  const float* hi = sm + 2 * ls;
  const float* mv = sm + 3 * ls;
  const float* span = sm + 4 * ls;
  const Coef2 cf{bboth(p.w), bboth(p.c1), bboth(p.c2), p.k0, p.k1, p.k2};
  // the hash's element terms (index = particle*D + dim) at (i, k0); a
  // dimension further adds one constant, particle i + 1 is D elements on
  const uint32_t idx = (uint32_t)i * (uint32_t)D + (uint32_t)k0;
  uint32_t a = idx * 0x27D4EB2Fu, t = idx * 0x9E3779B9u + hh.ts;
  const uint32_t da = (uint32_t)D * 0x27D4EB2Fu;
  const uint32_t dt = (uint32_t)D * 0x9E3779B9u;
  const int col = c.col + i;
  auto update = [&](int k, bf2 x, bf2 v, bf2 pb) {
    const size_t o = (size_t)k * p.ld + col;
    const uint32_t a1 = a + da, t1 = t + dt;
    const bf2 r1 = draw_pair(draw24(hh.h1 + a, t), draw24(hh.h1 + a1, t1));
    const bf2 r2 = draw_pair(draw24(hh.h2 + a, t), draw24(hh.h2 + a1, t1));
    a += 0x27D4EB2Fu;
    t += 0x9E3779B9u;
    const int j = k - k0;
    const bf2 m = bboth(mv[j]);
    advance2<R>(cf, r1, r2, x, v, pb, bboth(att[j]),
                Row2{bboth(lo[j]), bboth(hi[j]), m, m ^ 0x80008000u,
                     bboth(span[j])});
    st2(p.pos + o, x);
    if (R != 1) st2(p.vel + o, v);    // sso leaves vel as it is
    obj.add(k, k0, x);
  };
  int k = k0;
  for (; k + kPairBatch <= k1; k += kPairBatch) {
    bf2 x[kPairBatch], v[kPairBatch], pb[kPairBatch];
#pragma unroll
    for (int j = 0; j < kPairBatch; ++j) {
      const size_t o = (size_t)(k + j) * p.ld + col;
      x[j] = ld2(p.pos + o);
      v[j] = R == 1 ? 0u : ld2(p.vel + o);
      pb[j] = ld2(p.pbp + o);
    }
#pragma unroll
    for (int j = 0; j < kPairBatch; ++j) update(k + j, x[j], v[j], pb[j]);
  }
  for (; k < k1; ++k) {
    const size_t o = (size_t)k * p.ld + col;
    update(k, ld2(p.pos + o), R == 1 ? 0u : ld2(p.vel + o),
           ld2(p.pbp + o));
  }
}

// The pbest fold of a pair, each particle on its own decision: its pbest
// fitness (where `fits`: every rank of a cluster decides, rank 0 writes)
// and its column over [k0, k1), one word a dimension where both improved.
template <bool TL>
__device__ __forceinline__ void fold_pair(const Params<Bf>& p, int col,
                                          int k0, int k1, bool up0, bool up1,
                                          float f0, float f1, bool fits,
                                          int* s_cnt) {
  if (!(up0 || up1)) return;       // rare at steady state
  if (TL && p.counts) s_cnt[3] = 1;
  if (fits) {
    if (up0) p.pbf[col] = narrow<Bf>(f0);
    if (up1) p.pbf[col + 1] = narrow<Bf>(f1);
  }
  const int j = up1 && !up0;       // the one lane that improved
  for (int k = k0; k < k1; ++k) {
    const size_t o = (size_t)k * p.ld + col;
    if (up0 && up1) st2(p.pbp + o, ld2(p.pos + o));
    else p.pbp[o + j] = p.pos[o + j];
  }
}

// The queue keys of a pair (0 where neither beats `best`).
__device__ __forceinline__ unsigned long long pair_key(float f0, float f1,
                                                       int i, float best) {
  const unsigned long long k0 = f0 > best ? make_key(f0, i) : 0ull;
  const unsigned long long k1 = f1 > best ? make_key(f1, i + 1) : 0ull;
  return k0 > k1 ? k0 : k1;
}

// step_block on pairs: thread l takes pairs l, l + blockDim, ... of the
// block (particles base + 2l, base + 2l + 1).
template <int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_pairs(
    const Params<Bf>& p, const Cta& c, uint32_t it, const float* sm,
    float best, int* s_cnt) {
  unsigned long long mine = 0ull;
  const Hash2 hh = hash_terms(c.seed, it);
  const int base = c.b * p.bn;
  for (int l = threadIdx.x; 2 * l < p.bn; l += blockDim.x) {
    const int i = base + 2 * l, col = c.col + i;
    const bf2 pbf = ld2(p.pbf + col);
    Objective2<F> obj;
    advance_pair<F, R, false>(p, c, i, hh, sm, obj);
    const float f0 = obj.lane(0).result(p.d), f1 = obj.lane(1).result(p.d);
    fold_pair<TL>(p, col, 0, p.d, f0 > blo(pbf), f1 > bhi(pbf), f0, f1,
                  true, s_cnt);
    const unsigned long long key = pair_key(f0, f1, i, best);
    mine = key > mine ? key : mine;
  }
  return mine;
}

// step_cluster on pairs: thread l is the pair base + 2l, base + 2l + 1
// (blockDim == bn / 2); each particle's partials at its own index of
// `part`, read back in rank order, and `pbf` both particles' pbest
// fitnesses.
template <int F, int R, bool TL>
__device__ __forceinline__ unsigned long long step_pairs_cluster(
    const Params<Bf>& p, const Cta& c, uint32_t it, const float* sm,
    float best, float* part, float2& pbf, int* s_cnt) {
  using Obj = Objective<Bf, F>;
  const cg::cluster_group cl = cg::this_cluster();
  const int l = 2 * (int)threadIdx.x, i = c.b * p.bn + l, col = c.col + i;
  {
    Objective2<F> obj;
    advance_pair<F, R, true>(p, c, i, hash_terms(c.seed, it), sm, obj);
    obj.lane(0).put(part, l, p.bn);
    obj.lane(1).put(part, l + 1, p.bn);
  }
  cl.sync();
  const float* r0 = cl.map_shared_rank(part, 0);
  Obj o0 = Obj::take(r0, l, p.bn), o1 = Obj::take(r0, l + 1, p.bn);
  for (int r = 1; r < p.csize; ++r) {
    const float* pr = cl.map_shared_rank(part, r);
    o0.join(Obj::take(pr, l, p.bn));
    o1.join(Obj::take(pr, l + 1, p.bn));
  }
  const float f0 = o0.result(p.d), f1 = o1.result(p.d);
  const bool up0 = f0 > pbf.x, up1 = f1 > pbf.y;
  if (up0) pbf.x = f0;
  if (up1) pbf.y = f1;
  fold_pair<TL>(p, col, c.k0, c.k1, up0, up1, f0, f1, c.rank == 0, s_cnt);
  return pair_key(f0, f1, i, best);
}
#endif  // PSO_T_BF16

// Contention counters (the port of the TPU kernels' telemetry variants),
// gated at run time on Params::counts: null when telemetry is off, so the
// kernels count nothing, no kernel is instantiated twice, and the off path
// holds no extra register across the iteration loop (the step functions'
// T flag only keeps the code out of the queue kernel, which has no
// counters). A CTA keeps its swarm's counts in
// shared memory, s_cnt: [0] queue updates, [1] publications, [2] block
// improvements, and [3] a flag that any thread whose particle improved
// its pbest raises inside the (rare) pbest fold. After the barrier that
// follows the queue's atomicMax, thread 0 counts the iteration
// (count_step) and clears the flag before the barrier that ends the
// iteration, which every raise of the next iteration follows. At kernel
// exit thread 0 of rank 0 adds the counts into counts[3*s .. 3*s+2] with
// one atomicAdd each, so they add up over the CTAs of a swarm and over
// launches. Every rank of a cluster takes the same queue and pbest
// decisions (step_cluster), so rank 0's counts are the block's.
__device__ __forceinline__ void count_step(int* s_cnt, bool queued,
                                           bool publishes) {
  if (queued) {
    ++s_cnt[0];
    if (publishes) ++s_cnt[1];
  }
  if (s_cnt[3]) {
    ++s_cnt[2];
    s_cnt[3] = 0;
  }
}

template <typename T>
__device__ __forceinline__ void add_counts(const Params<T>& p, const Cta& c,
                                           const int* s_cnt) {
  if (p.counts && threadIdx.x == 0 && c.rank == 0) {
    int* dst = p.counts + 3 * (size_t)c.s;
    atomicAdd(dst, s_cnt[0]);
    atomicAdd(dst + 1, s_cnt[1]);
    atomicAdd(dst + 2, s_cnt[2]);
  }
}

// ---------------------------------------------------------------------------
// Fused queue-lock: one CTA, or one cluster of C CTAs (CL), per particle
// block of each swarm, the iteration loop inside. With several blocks a
// swarm's CTAs meet at a grid-wide sync between iterations, so the launch
// is cooperative (G = true; with clusters, cooperative and clustered at
// once) and every CTA of the launch must be resident; the wrapper launches
// a large batch in waves of whole swarms, which is exact because swarms
// are independent. With one block a CTA or cluster is its whole swarm and
// needs no grid sync: a normal launch for any S.
//
// Semantics: synchronous PPSO. Every CTA reads its swarm's gbest of
// iteration t-1 (the TPU kernel's block b also sees what blocks 0..b-1
// published in the same iteration, an artifact of its sequential grid;
// concurrent CTAs cannot give that order without running one after
// another). With one block both agree exactly.
//
// Publication (§5.3): only the winner's index travels, inside the key. Each
// CTA with a candidate raises its swarm's keys[s][t&1] with one atomicMax
// and copies its block winner's column into cand[t&1][s*nb + block]. After
// grid.sync() every CTA decodes the key (the index is local to the swarm,
// so index / bn is the winning block) and reads the winner's D floats from
// that candidate column into its shared gbest.
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
//  * Within the CTA, the block's key s_key is double-buffered by parity:
//    slot par^1 is cleared after the barrier that follows every read of it
//    and before the barrier that precedes its next atomicMax.
//  * Cluster: the partials of parity par are written in iteration t and
//    read remotely after that iteration's cluster.sync(); they are written
//    again in t+2, after the cluster.sync() of t+1, which every reader of
//    t has passed. A CTA leaves only after a last cluster.sync(), so no
//    rank reads the shared memory of a CTA that has exited. Each rank
//    copies its slice of the block winner and gathers its slice of the
//    swarm's winner; rank 0 alone raises the swarm's key.
//
// Counters: a block whose queue is non-empty (bk != 0) raises the swarm's
// key (or, alone, takes its winner), so it counts a queue update and a
// publication at once: queue_updates == publications, as in the TPU
// kernel, and both <= block_improvements, since a lane that beats gbest
// also beats its own pbest.
// ---------------------------------------------------------------------------
template <typename T, int F, int R, bool G, int P>
__device__ __forceinline__ void fused_body(const Params<T>& p, const Cta& c,
                                           float* sm,
                                           unsigned long long* s_key,
                                           int* s_cnt) {
  const int D = p.d, tid = threadIdx.x, nt = blockDim.x;
  float gf = widen(p.gf[c.s]);
  int par = 0;
  for (int t = 0; t < p.iters; ++t) {
    const uint32_t it = c.it0 + (uint32_t)t + 1u;
    const unsigned long long mine =
        step_any<T, F, R, true, P>(p, c, it, sm, gf, s_cnt);
    if (mine) atomicMax(&s_key[par], mine);      // the intra-block queue
    __syncthreads();
    const unsigned long long bk = s_key[par];
    if (tid == 0) {
      s_key[par ^ 1] = 0ull;
      if (p.counts) count_step(s_cnt, bk != 0ull, true);
    }
    if constexpr (G) {
      const int slot = t & 1;
      unsigned long long* key = p.keys + 2 * (size_t)c.s + slot;
      T* cand = p.cand + ((size_t)slot * p.s_cnt + c.s) * p.nb * D;
      if (bk) {
        const int wi = c.col + key_index(bk);
        for (int k = tid; k < D; k += nt)
          cand[(size_t)c.b * D + k] = p.pos[(size_t)k * p.ld + wi];
        if (tid == 0) atomicMax(key, bk);
      }
      cg::this_grid().sync();
      const unsigned long long gk = __ldcg(key);
      const float kf = key_fit(gk);
      if (gk != 0ull && kf > gf) {
        gf = kf;
        const T* win = cand + (size_t)(key_index(gk) / p.bn) * D;
        for (int k = tid; k < D; k += nt) sm[k] = ldcg(win + k);
      }
    } else if (bk) {  // one block: every candidate beats gf, the best wins
      gf = key_fit(bk);
      const int wi = c.col + key_index(bk);
      for (int k = tid; k < D; k += nt)
        sm[k] = widen(p.pos[(size_t)k * p.ld + wi]);
    }
    __syncthreads();
    par ^= 1;
  }
  if (c.b == 0) {
    for (int k = tid; k < D; k += nt)
      p.gp[(size_t)k * p.s_cnt + c.s] = narrow<T>(sm[k]);
    if (tid == 0) p.gf[c.s] = narrow<T>(gf);
  }
}

template <typename T, int F, int R, bool G, int P>
__device__ __forceinline__ void fused_cluster_body(const Params<T>& p,
                                                   const Cta& c, float* sm,
                                                   unsigned long long* s_key,
                                                   int* s_cnt) {
  const int D = p.d, tid = threadIdx.x, nt = blockDim.x;
  float* part = partials(c, sm);
  float gf = widen(p.gf[c.s]);
  Pbf<P> pbf = load_pbf<P>(p, c);
  int par = 0;
  for (int t = 0; t < p.iters; ++t) {
    const uint32_t it = c.it0 + (uint32_t)t + 1u;
    const unsigned long long mine = step_any_cluster<T, F, R, true, P>(
        p, c, it, sm, gf, part + par * 3 * p.bn, pbf, s_cnt);
    if (mine) atomicMax(&s_key[par], mine);      // the intra-block queue
    __syncthreads();
    const unsigned long long bk = s_key[par];
    if (tid == 0) {
      s_key[par ^ 1] = 0ull;
      if (p.counts) count_step(s_cnt, bk != 0ull, true);
    }
    if constexpr (G) {
      const int slot = t & 1;
      unsigned long long* key = p.keys + 2 * (size_t)c.s + slot;
      T* cand = p.cand + ((size_t)slot * p.s_cnt + c.s) * p.nb * D;
      if (bk) {
        const int wi = c.col + key_index(bk);
        for (int k = c.k0 + tid; k < c.k1; k += nt)
          cand[(size_t)c.b * D + k] = p.pos[(size_t)k * p.ld + wi];
        if (c.rank == 0 && tid == 0) atomicMax(key, bk);
      }
      cg::this_grid().sync();
      const unsigned long long gk = __ldcg(key);
      const float kf = key_fit(gk);
      if (gk != 0ull && kf > gf) {
        gf = kf;
        const T* win = cand + (size_t)(key_index(gk) / p.bn) * D;
        for (int k = c.k0 + tid; k < c.k1; k += nt)
          sm[k - c.k0] = ldcg(win + k);
      }
    } else if (bk) {  // one block: every candidate beats gf, the best wins
      gf = key_fit(bk);
      const int wi = c.col + key_index(bk);
      for (int k = c.k0 + tid; k < c.k1; k += nt)
        sm[k - c.k0] = widen(p.pos[(size_t)k * p.ld + wi]);
    }
    __syncthreads();
    par ^= 1;
  }
  if (c.b == 0) {
    for (int k = c.k0 + tid; k < c.k1; k += nt)
      p.gp[(size_t)k * p.s_cnt + c.s] = narrow<T>(sm[k - c.k0]);
    if (c.rank == 0 && tid == 0) p.gf[c.s] = narrow<T>(gf);
  }
  cg::this_cluster().sync();
}

template <typename T, int F, int R, bool G, bool CL, int P>
__device__ __forceinline__ void fused_any(const Params<T>& p, const Cta& c,
                                          float* sm,
                                          unsigned long long* s_key,
                                          int* s_cnt) {
  if constexpr (CL)
    fused_cluster_body<T, F, R, G, P>(p, c, sm, s_key, s_cnt);
  else
    fused_body<T, F, R, G, P>(p, c, sm, s_key, s_cnt);
}

// The fused kernel's CTA, P particles a thread (step_any).
template <typename T, int F, int R, bool G, bool CL, int P>
__device__ __forceinline__ void fused_entry(const Params<T>& p) {
  extern __shared__ float sm[];
  __shared__ unsigned long long s_key[2];
  __shared__ int s_cnt[4];
  const Cta c = cta_of<CL>(p);
  load_rows<CL>(p, c, sm, p.gp, (size_t)p.s_cnt, (size_t)c.s);
  if (threadIdx.x == 0) {
    s_key[0] = s_key[1] = 0ull;
    s_cnt[0] = s_cnt[1] = s_cnt[2] = s_cnt[3] = 0;
  }
  __syncthreads();
  if constexpr (F < kHetero) {
    fused_any<T, F, R, G, CL, P>(p, c, sm, s_key, s_cnt);
  } else {
    switch (p.member_fit[c.member]) {   // uniform across the CTA
      case 0: fused_any<T, 0, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
      case 1: fused_any<T, 1, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
      case 2: fused_any<T, 2, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
      case 3: fused_any<T, 3, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
      case 4: fused_any<T, 4, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
      default: fused_any<T, 5, R, G, CL, P>(p, c, sm, s_key, s_cnt); break;
    }
  }
  add_counts(p, c, s_cnt);
}

template <typename T, int F, int R, bool G, bool CL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    fused_kernel(Params<T> p) {
  fused_entry<T, F, R, G, CL, 1>(p);
}

// The bfloat16 pair path's fused kernel (bn / 2 threads a cluster CTA).
template <typename T, int F, int R, bool G, bool CL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    fused_pair_kernel(Params<T> p) {
  fused_entry<T, F, R, G, CL, 2>(p);
}

// ---------------------------------------------------------------------------
// Async queue-lock: a normal launch, one CTA, or one cluster of C CTAs
// (CL), per particle block of each swarm, resident for its whole span. Each
// chunk runs `chunk` iterations against the block's local best in shared
// memory; the swarm's shared gbest (fit + D floats, which no single atomic
// covers) is touched only at chunk boundaries. More CTAs than fit on the
// card at once is safe: a CTA that holds a lock, or has a write in flight,
// is running.
//
// At a boundary a CTA publishes its local best if it beats gbest, otherwise
// pulls gbest if it beats the local best — the TPU kernel's chunk-exit
// publish followed by the next chunk's entry pull. The order of
// publications across a swarm's CTAs is a race by design; with one block
// the kernel equals the fused kernel for every chunk length.
//
// Each swarm's gbest is guarded by the paper's lock plus a sequence counter
// (lock[s][0] mutex, lock[s][1] sequence; a seqlock). Writers take the
// atomicCAS spin lock (thread 0), make the sequence odd, copy with the
// whole CTA between __syncthreads, __threadfence, make it even and release.
// Readers take no lock: they read the sequence, the fitness and the D
// floats, and retry if the sequence was odd or moved. All reads of the
// shared gbest bypass L1 (__ldcg), which is not coherent across SMs.
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
//
// On a cluster the particle step is the fused kernel's (step_cluster) and
// the boundary runs once a cluster (boundary_cluster): thread 0 of rank 0
// alone reads gbest, decides, spins on the lock and moves the sequence;
// every rank copies its slice of the D floats.
//
// Counters: a queue update is an iteration of a block whose queue is
// non-empty (it raises the block's local best); a publication is a write
// to the shared gbest that landed, counted by the thread that makes the
// sequence even again, after the re-check under the lock: an attempt that
// loses the re-check is none. Publications happen only at boundaries, at
// most once a chunk a block.
// ---------------------------------------------------------------------------
enum BoundaryAct { kNone = 0, kPublish = 1, kPull = 2 };

template <typename T>
__device__ __forceinline__ float boundary(const Params<T>& p, const Cta& c,
                                          float* att, float lf, bool publish,
                                          bool pull, float* s_g, int* s_act,
                                          int* s_cnt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned* mutex = p.lock + 2 * (size_t)c.s;
  unsigned* seq = mutex + 1;
  T* gf = p.gf + c.s;
  T* gp = p.gp + c.s;                 // column s of [D, S]: stride s_cnt
  const size_t ld = (size_t)p.s_cnt;
  if (tid == 0) {
    const float g = ldcg(gf);
    *s_act = (publish && lf > g) ? kPublish : ((pull && g > lf) ? kPull : kNone);
  }
  __syncthreads();
  int act = *s_act;
  if (act == kPublish) {
    if (tid == 0) {
      while (atomicCAS(mutex, 0u, 1u) != 0u) __nanosleep(64);
      __threadfence();
      const float g = ldcg(gf);
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
      for (int k = tid; k < p.d; k += nt) stcg(gp + k * ld, att[k]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      if (act == kPublish) {
        stcg(gf, lf);
        __threadfence();
        atomicAdd(seq, 1u);                 // even: the write is complete
        if (p.counts) ++s_cnt[1];
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
        *s_g = ldcg(gf);
        s_act[1] = (int)s1;
      }
      __syncthreads();
      for (int k = tid; k < p.d; k += nt) att[k] = ldcg(gp + k * ld);
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

// The boundary on a cluster. Rank 0's thread 0 (the lead) decides for the
// cluster and hands its decision, the fitness it read and the sequence it
// saw to every rank through its own shared memory (s_act, s_g, read over
// DSMEM after a cluster.sync()): ranks that read gf themselves could see
// different values, since another cluster may publish between their reads,
// decide differently and deadlock at the next cluster barrier. Each slot of
// s_act is written once a boundary and read after the barrier that follows
// the write: [0] the first decision, [1] the decision under the lock, [2]
// the sequence a pull started from, [3] whether that pull was torn; the
// next write to a slot comes after at least one more barrier (the chunk's
// iterations, or a retry's first), which every reader has passed.
//
// Memory order: barrier.cluster orders memory only at cluster scope, while
// readers on other SMs observe gp at gpu scope. So every rank fences at gpu
// scope (__threadfence) after its slice's stores or loads and before the
// cluster barrier after which the lead moves or re-reads the sequence:
// that fence is what makes a published slice visible before the sequence
// turns even, and a pulled slice read before the sequence is checked again.
// The lead spins alone; the cluster's other threads wait at the barrier. A
// cluster is co-scheduled, so a cluster that holds the lock is resident.
template <typename T>
__device__ __forceinline__ float boundary_cluster(const Params<T>& p,
                                                  const Cta& c, float* att,
                                                  float lf, bool publish,
                                                  bool pull, float* s_g,
                                                  int* s_act, int* s_cnt) {
  const cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = c.rank == 0 && tid == 0;
  unsigned* mutex = p.lock + 2 * (size_t)c.s;
  unsigned* seq = mutex + 1;
  T* gf = p.gf + c.s;
  T* gp = p.gp + c.s;                 // column s of [D, S]: stride s_cnt
  const size_t ld = (size_t)p.s_cnt;
  const int* act_of = cl.map_shared_rank(s_act, 0);   // the lead's slots
  if (lead) {
    const float g = ldcg(gf);
    s_act[0] = (publish && lf > g) ? kPublish
                                   : ((pull && g > lf) ? kPull : kNone);
  }
  cl.sync();
  int act = act_of[0];
  if (act == kPublish) {
    if (lead) {
      while (atomicCAS(mutex, 0u, 1u) != 0u) __nanosleep(64);
      __threadfence();
      const float g = ldcg(gf);
      const bool win = lf > g;
      if (win) {
        atomicAdd(seq, 1u);                 // odd: a write is in flight
        __threadfence();
      }
      s_act[1] = win ? kPublish : ((pull && g > lf) ? kPull : kNone);
    }
    cl.sync();
    act = act_of[1];
    if (act == kPublish)
      for (int k = c.k0 + tid; k < c.k1; k += nt)
        stcg(gp + k * ld, att[k - c.k0]);
    __threadfence();                        // the slice, at gpu scope
    cl.sync();
    if (lead) {
      if (act == kPublish) {
        stcg(gf, lf);
        __threadfence();
        atomicAdd(seq, 1u);                 // even: the write is complete
        if (p.counts) ++s_cnt[1];
      }
      __threadfence();
      atomicExch(mutex, 0u);
    }
  }
  if (act == kPull) {
    for (;;) {
      if (lead) {
        unsigned s1;
        while ((s1 = __ldcg(seq)) & 1u) __nanosleep(32);
        __threadfence();
        *s_g = ldcg(gf);
        s_act[2] = (int)s1;
      }
      cl.sync();
      for (int k = c.k0 + tid; k < c.k1; k += nt)
        att[k - c.k0] = ldcg(gp + k * ld);
      __threadfence();                      // the slice, before the re-read
      cl.sync();
      if (lead) s_act[3] = __ldcg(seq) != (unsigned)s_act[2];
      cl.sync();
      if (!act_of[3]) break;                // torn: every rank retries
    }
    lf = *cl.map_shared_rank(s_g, 0);       // gbest only grows: still > lf
  }
  return lf;
}

// ---------------------------------------------------------------------------
// lbest topologies (the TPU kernel's topology="ring" | "vonneumann", ported
// from repro/core/topology.py). A block's chunk entry does not pull the
// shared gbest: it folds its neighbour blocks' local-best slots lp[:, slot],
// lf[slot] (slot = s*nb + block) into its own local best, and its own slot
// is where the neighbours read it. The shared gbest is still flushed at
// every boundary after a chunk (boundary with pull = false), for
// monitoring and the final answer, and never read back.
//
// On the TPU the grid runs block-major, so block b's fold sees block b-1's
// slot after b-1's whole span and block b+1's as it was at launch. CUDA
// blocks run at once, so on the card the neighbour reads are a race, as the
// gbest publications are: each slot is guarded by its own sequence counter
// (slot_seq[slot], a seqlock). A slot has one writer, its block, so no
// mutex is needed: the writer makes the sequence odd, stores the D floats
// and the fitness (__stcg, past L1), fences, and makes it even. It writes
// only when its local best rose since it last wrote (a local best only
// grows), at a boundary after a chunk.
//
// The fold reads all neighbours' sequences and fitnesses together, one
// thread a neighbour (2 for the ring, 4 for von Neumann), strided over the
// CTA's threads where it has fewer: a loop of 2-4 dependent L2 round trips
// would add microseconds to every boundary, while a chunk of 8 iterations
// at d=1 takes about 8 us. The winner is the first maximum in
// kernel_neighbor_ids order with the block itself first and a
// strict >, which is the sequential running max of every engine. Only the
// winner's D floats are copied, into the shared attractor; then its
// sequence is read again and the fold retried if it moved. A reader spins
// only while a sequence is odd, which its writer holds only while it is
// resident and mid-write, so no block waits for another to reach a
// boundary, whatever the residency.
//
// On a cluster the boundary_cluster discipline holds: the lead (thread 0 of
// rank 0) moves the sequence and decides, threads of rank 0 read the
// neighbours, every rank stores or loads its slice of the D floats and
// fences at gpu scope before the cluster barrier after which the lead
// moves or re-reads the sequence, and the lead's decision reaches every
// rank over DSMEM.
// ---------------------------------------------------------------------------
constexpr int kRing = 1, kVonNeumann = 2;
constexpr int kMaxNeighbors = 4;

__device__ __forceinline__ int neighbor_count(int topo) {
  return topo == kRing ? 2 : kMaxNeighbors;
}

// Neighbour k of block b (core/topology.py kernel_neighbor_ids): ring b-1,
// b+1; von Neumann, on a rows x cols torus, the row above, below, the
// column left, right. A small nb may give b itself.
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

template <typename T>
__device__ __forceinline__ size_t neighbor_slot(const Params<T>& p,
                                                const Cta& c, int k) {
  return (size_t)c.s * p.nb +
         neighbor_id(c.b, p.nb, p.topo, p.grid_r, p.grid_c, k);
}

// Writes the block's local best (the attractor att of the CTA's dimensions
// and lf) into its slot under the slot's sequence.
template <bool CL, typename T>
__device__ __forceinline__ void publish_slot(const Params<T>& p,
                                             const Cta& c, const float* att,
                                             float lf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = c.rank == 0 && tid == 0;
  const size_t slot = (size_t)c.s * p.nb + c.b;
  const size_t lds = (size_t)p.s_cnt * p.nb;
  unsigned* seq = p.slot_seq + slot;
  const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : p.d;
  if (lead) {
    atomicAdd(seq, 1u);                     // odd: a write is in flight
    __threadfence();
  }
  if constexpr (CL) cg::this_cluster().sync(); else __syncthreads();
  for (int k = k0 + tid; k < k1; k += nt)
    stcg(p.lp + k * lds + slot, att[k - k0]);
  if (lead) stcg(p.lf + slot, lf);
  __threadfence();                          // the slice, at gpu scope
  if constexpr (CL) cg::this_cluster().sync(); else __syncthreads();
  if (lead) atomicAdd(seq, 1u);             // even: the write is complete
}

// The chunk-entry fold: returns the new local best's fitness and leaves its
// D floats (the CTA's slice) in att. Shared slots, all on rank 0 and read
// by the other ranks over DSMEM: s_nf/s_ns each neighbour's fitness and
// the sequence it was read at, s_dec[0] the winner (-1: none beats lf),
// s_dec[1] whether its copy was torn. Each is written once a round and
// read after the barrier that follows the write; the next write comes
// after the barrier that ends the round, or after a chunk's iterations.
template <bool CL, typename T>
__device__ __forceinline__ float fold_neighbors(const Params<T>& p,
                                                const Cta& c, float* att,
                                                float lf) {
  __shared__ float s_nf[kMaxNeighbors];
  __shared__ unsigned s_ns[kMaxNeighbors];
  __shared__ int s_dec[2];
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = c.rank == 0 && tid == 0;
  const int nbrs = neighbor_count(p.topo);
  const size_t lds = (size_t)p.s_cnt * p.nb;
  const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : p.d;
  const float* nf = s_nf;
  const int* dec = s_dec;
  if constexpr (CL) {
    nf = cg::this_cluster().map_shared_rank(&s_nf[0], 0);
    dec = cg::this_cluster().map_shared_rank(&s_dec[0], 0);
  }
  auto sync = [] {
    if constexpr (CL) cg::this_cluster().sync(); else __syncthreads();
  };
  for (;;) {
    if (c.rank == 0) {                      // every neighbour at once
      for (int k = tid; k < nbrs; k += nt) {
        const size_t slot = neighbor_slot(p, c, k);
        unsigned s1;
        while ((s1 = __ldcg(p.slot_seq + slot)) & 1u) __nanosleep(32);
        __threadfence();
        s_nf[k] = ldcg(p.lf + slot);
        s_ns[k] = s1;
      }
    }
    sync();
    if (lead) {                             // self first, strict >
      float best = lf;
      int w = -1;
      for (int k = 0; k < nbrs; ++k)
        if (s_nf[k] > best) {
          best = s_nf[k];
          w = k;
        }
      s_dec[0] = w;
    }
    sync();
    const int w = dec[0];
    if (w < 0) return lf;
    const size_t slot = neighbor_slot(p, c, w);
    for (int k = k0 + tid; k < k1; k += nt)
      att[k - k0] = ldcg(p.lp + k * lds + slot);
    __threadfence();                        // the slice, before the re-read
    sync();
    if (lead) s_dec[1] = __ldcg(p.slot_seq + slot) != s_ns[w];
    sync();
    const bool torn = dec[1];
    const float f = nf[w];
    sync();                                 // read before a retry rewrites
    if (!torn) return f;    // a slot only grows: f still beats lf
  }
}

// The chunk loop. On a cluster (CL) each rank keeps its own copy of the
// block's local best lf and of the queue key s_key, and they stay
// identical without any communication inside a chunk: step_cluster gives
// every rank the same fitness bits for every particle, so every rank
// raises the same keys, takes the same block winner and copies its own
// slice of it; the boundary hands every rank the lead's gbest. pbest
// fitness is kept in a register by every rank, as in the fused kernel.
// The partials alternate by iteration parity across chunks; every
// boundary adds cluster barriers, which only separate a parity's write
// from its next reuse further.
//
// Under an lbest topology (LB) a boundary after a chunk writes the block's
// slot where its local best rose since the last write (`pub`: the fitness
// the slot holds, at first the launch's) and flushes to gbest without
// pulling; a boundary before a chunk folds the neighbours' slots. The
// local best, and so the decision to write, is the same on every thread
// and every rank.
template <typename T, int F, int R, bool CL, bool LB, int P>
__device__ __forceinline__ float async_body(const Params<T>& p, const Cta& c,
                                            float* sm, float lf,
                                            unsigned long long* s_key,
                                            float* s_g, int* s_act,
                                            int* s_cnt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : p.d;
  const int chunks = p.iters / p.chunk;
  float* part = partials(c, sm);
  Pbf<P> pbf = CL ? load_pbf<P>(p, c) : Pbf<P>{};
  int par = 0;
  float pub = lf;
  for (int ch = 0; ch <= chunks; ++ch) {
    if constexpr (LB) {
      if (ch > 0) {
        if (lf != pub) {
          publish_slot<CL>(p, c, sm, lf);
          pub = lf;
        }
        if constexpr (CL)
          boundary_cluster(p, c, sm, lf, true, false, s_g, s_act, s_cnt);
        else
          boundary(p, c, sm, lf, true, false, s_g, s_act, s_cnt);
      }
      if (ch < chunks) lf = fold_neighbors<CL>(p, c, sm, lf);
    } else if constexpr (CL) {
      lf = boundary_cluster(p, c, sm, lf, ch > 0, ch < chunks, s_g, s_act,
                            s_cnt);
    } else {
      lf = boundary(p, c, sm, lf, ch > 0, ch < chunks, s_g, s_act, s_cnt);
    }
    if (ch == chunks) break;
    for (int tl = 0; tl < p.chunk; ++tl) {
      const uint32_t it = c.it0 + (uint32_t)(ch * p.chunk + tl) + 1u;
      unsigned long long mine;
      if constexpr (CL)
        mine = step_any_cluster<T, F, R, true, P>(
            p, c, it, sm, lf, part + par * 3 * p.bn, pbf, s_cnt);
      else
        mine = step_any<T, F, R, true, P>(p, c, it, sm, lf, s_cnt);
      if (mine) atomicMax(&s_key[par], mine);
      __syncthreads();
      // s_key[par ^ 1] was last read before the barrier above; clearing it
      // here keeps every clear ahead of the next iteration's atomicMax.
      const unsigned long long bk = s_key[par];
      if (tid == 0) {
        s_key[par ^ 1] = 0ull;
        if (p.counts) count_step(s_cnt, bk != 0ull, false);
      }
      if (bk) {     // every candidate beats lf, so the block's best is taken
        lf = key_fit(bk);
        const int wi = c.col + key_index(bk);
        for (int k = k0 + tid; k < k1; k += nt)
          sm[k - k0] = widen(p.pos[(size_t)k * p.ld + wi]);
      }
      __syncthreads();
      par ^= 1;
    }
  }
  return lf;
}

// The (512, 2) bound caps the async kernel at 64 registers, as the fused
// one. Its normal launch does not need every CTA resident, but the cap
// measured faster on the main path's d=120 swarm: cubic d=120 n=32768
// async ran 54.96 and 56.43 us an iteration with it against 67.38 and 68.40
// without (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, one call, runs in
// the order with, without, without, with); at d=1 the two were within the
// runs' spread. On a cluster every rank writes its slice of the local best
// and rank 0 its fitness, and a last cluster.sync() keeps every CTA until
// no rank can still read its shared memory (the lead's slots, the
// partials); the remainder phase's launch resumes from lp and lf. Under an
// lbest topology (LB) the last boundary has already written the slot. The
// CTA, P particles a thread (step_any):
template <typename T, int F, int R, bool CL, bool LB, int P>
__device__ __forceinline__ void async_entry(const Params<T>& p) {
  extern __shared__ float sm[];
  __shared__ unsigned long long s_key[2];
  __shared__ float s_g;
  __shared__ int s_act[CL ? 4 : 3];
  __shared__ int s_cnt[4];
  const Cta c = cta_of<CL>(p);
  const size_t slot = (size_t)c.s * p.nb + c.b;   // per-(swarm, block) local
  const size_t lds = (size_t)p.s_cnt * p.nb;
  load_rows<CL>(p, c, sm, p.lp, lds, slot);
  if (threadIdx.x == 0) {
    s_key[0] = s_key[1] = 0ull;
    s_cnt[0] = s_cnt[1] = s_cnt[2] = s_cnt[3] = 0;
  }
  float lf = widen(p.lf[slot]);
  __syncthreads();
  if constexpr (F < kHetero) {
    lf = async_body<T, F, R, CL, LB, P>(p, c, sm, lf, s_key, &s_g, s_act,
                                        s_cnt);
  } else {
    switch (p.member_fit[c.member]) {   // uniform across the cluster
      case 0:
        lf = async_body<T, 0, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
      case 1:
        lf = async_body<T, 1, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
      case 2:
        lf = async_body<T, 2, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
      case 3:
        lf = async_body<T, 3, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
      case 4:
        lf = async_body<T, 4, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
      default:
        lf = async_body<T, 5, R, CL, LB, P>(p, c, sm, lf, s_key,
                                             &s_g, s_act, s_cnt);
        break;
    }
  }
  if constexpr (!LB) {
    const int k0 = CL ? c.k0 : 0, k1 = CL ? c.k1 : p.d;
    for (int k = k0 + (int)threadIdx.x; k < k1; k += blockDim.x)
      p.lp[(size_t)k * lds + slot] = narrow<T>(sm[k - k0]);
    if (threadIdx.x == 0 && c.rank == 0) p.lf[slot] = narrow<T>(lf);
  }
  add_counts(p, c, s_cnt);
  if constexpr (CL) cg::this_cluster().sync();
}

template <typename T, int F, int R, bool CL, bool LB = false>
__global__ void __launch_bounds__(kMaxThreads, 2)
    async_kernel(Params<T> p) {
  async_entry<T, F, R, CL, LB, 1>(p);
}

// The bfloat16 pair path's async kernel (bn / 2 threads a cluster CTA).
template <typename T, int F, int R, bool CL, bool LB = false>
__global__ void __launch_bounds__(kMaxThreads, 2)
    async_pair_kernel(Params<T> p) {
  async_entry<T, F, R, CL, LB, 2>(p);
}

// ---------------------------------------------------------------------------
// Queue algorithm (§4.1), kernel 1 of 2: a normal launch of one CTA, or
// one cluster of C CTAs (CL), per particle block of one swarm, one
// iteration; the particle step is the fused kernel's, so the two agree bit
// for bit. gbest is read-only: every CTA compares against the input gf
// (the stale gbest of the iteration before), advances its block and folds
// pbest in place. The intra-CTA atomicMax on s_key is the paper's
// intra-group queue; thread 0 (of rank 0) decodes the block's key
// into aux_fit[b] (the best fitness among lanes that beat gf, -inf when none
// does) and aux_idx[b] (that lane's swarm-local index, first lane on ties;
// the block base when the queue is empty, as the reference's _queue_best
// gives). No grid sync, no candidate columns, no lock: kernel 2 of the
// paper, the cross-block argmax and gather, is the caller's epilogue.
// ---------------------------------------------------------------------------
// The queue kernel's CTA, P particles a thread (step_any).
template <typename T, int F, int R, bool CL, int P>
__device__ __forceinline__ void queue_entry(const Params<T>& p) {
  extern __shared__ float sm[];
  __shared__ unsigned long long s_key;
  const Cta c = cta_of<CL>(p);
  load_rows<CL>(p, c, sm, p.gp, (size_t)p.s_cnt, (size_t)c.s);
  if (threadIdx.x == 0) s_key = 0ull;
  unsigned long long mine;
  if constexpr (CL) {       // the queue kernel has no counters: T = false
    Pbf<P> pbf;
    if constexpr (P == 2)
      pbf = load_pbf<2>(p, c);
    else    // the lane kernels' own index form: their float32 SASS is
            // held still (tools/kernel_trees.py)
      pbf = widen(p.pbf[c.col + c.b * p.bn + threadIdx.x]);
    __syncthreads();
    mine = step_any_cluster<T, F, R, false, P>(p, c, c.it0 + 1u, sm,
                                               widen(p.gf[c.s]),
                                               partials(c, sm), pbf, nullptr);
  } else {
    __syncthreads();
    mine = step_any<T, F, R, false, P>(p, c, c.it0 + 1u, sm,
                                       widen(p.gf[c.s]), nullptr);
  }
  if (mine) atomicMax(&s_key, mine);
  __syncthreads();
  if (threadIdx.x == 0 && c.rank == 0) {
    const unsigned long long bk = s_key;
    p.aux_fit[c.b] =
        narrow<T>(bk ? key_fit(bk) : __uint_as_float(0xff800000u));  // -inf
    p.aux_idx[c.b] = bk ? key_index(bk) : c.b * p.bn;
  }
  if constexpr (CL) cg::this_cluster().sync();   // partials read remotely
}

template <typename T, int F, int R, bool CL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    queue_kernel(Params<T> p) {
  queue_entry<T, F, R, CL, 1>(p);
}

// The bfloat16 pair path's queue kernel (bn / 2 threads a cluster CTA):
// the keys of a pair meet in the same atomicMax, so aux_fit and aux_idx
// (first lane on ties) are the lane path's.
template <typename T, int F, int R, bool CL>
__global__ void __launch_bounds__(kMaxThreads, 2)
    queue_pair_kernel(Params<T> p) {
  queue_entry<T, F, R, CL, 2>(p);
}

// The neighbour ids of every block, as the lbest folds compute them, into
// out[nb, neighbor_count(topo)]: the test entry pso_neighbor_ids.
__global__ void neighbors_kernel(int nb, int topo, int rows, int cols,
                                 int* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int m = neighbor_count(topo);
  for (int k = 0; k < m; ++k)
    out[b * m + k] = neighbor_id(b, nb, topo, rows, cols, k);
}

using Kernel = void (*)(Params<Store>);

// PSO_TABLE(kernel, <empty> or <empty>, <more template arguments>): the
// variadic tail is pasted after the rule id, so `, true` selects
// <Store, F, R, true>. The bfloat16 library has no heterogeneous row.
#define PSO_RULES(K, F, ...) {K<Store, F, 0 __VA_ARGS__>,                  \
                              K<Store, F, 1 __VA_ARGS__>,                  \
                              K<Store, F, 2 __VA_ARGS__>}
#define PSO_BUILTINS(K, ...)                                               \
  PSO_RULES(K, 0, __VA_ARGS__), PSO_RULES(K, 1, __VA_ARGS__),              \
  PSO_RULES(K, 2, __VA_ARGS__), PSO_RULES(K, 3, __VA_ARGS__),              \
  PSO_RULES(K, 4, __VA_ARGS__), PSO_RULES(K, 5, __VA_ARGS__)
#ifdef PSO_T_BF16
constexpr int kTableFits = kFitnessCount;
#define PSO_TABLE(K, ...) {PSO_BUILTINS(K, __VA_ARGS__)}
#else
constexpr int kTableFits = kHetero + 1;
#define PSO_TABLE(K, ...)                                                  \
  {PSO_BUILTINS(K, __VA_ARGS__), PSO_RULES(K, 6, __VA_ARGS__)}
#endif

// [cluster][objective or kHetero][rule]
const Kernel kFusedGrid[2][kTableFits][kRuleCount] = {
    PSO_TABLE(fused_kernel, , true, false),
    PSO_TABLE(fused_kernel, , true, true)};
const Kernel kFusedBlock[2][kTableFits][kRuleCount] = {
    PSO_TABLE(fused_kernel, , false, false),
    PSO_TABLE(fused_kernel, , false, true)};
const Kernel kAsync[2][kTableFits][kRuleCount] = {
    PSO_TABLE(async_kernel, , false), PSO_TABLE(async_kernel, , true)};
// [cluster][objective or kHetero][rule], lbest topologies
const Kernel kAsyncLbest[2][kTableFits][kRuleCount] = {
    PSO_TABLE(async_kernel, , false, true),
    PSO_TABLE(async_kernel, , true, true)};
// [cluster][objective][rule]: one swarm, no heterogeneous form
const Kernel kQueue[2][kFitnessCount][kRuleCount] = {
    {PSO_BUILTINS(queue_kernel, , false)},
    {PSO_BUILTINS(queue_kernel, , true)}};
#ifdef PSO_T_BF16
// The pair path's tables, laid out as the lane path's above.
const Kernel kFusedPairGrid[2][kTableFits][kRuleCount] = {
    PSO_TABLE(fused_pair_kernel, , true, false),
    PSO_TABLE(fused_pair_kernel, , true, true)};
const Kernel kFusedPairBlock[2][kTableFits][kRuleCount] = {
    PSO_TABLE(fused_pair_kernel, , false, false),
    PSO_TABLE(fused_pair_kernel, , false, true)};
const Kernel kAsyncPair[2][kTableFits][kRuleCount] = {
    PSO_TABLE(async_pair_kernel, , false),
    PSO_TABLE(async_pair_kernel, , true)};
const Kernel kAsyncPairLbest[2][kTableFits][kRuleCount] = {
    PSO_TABLE(async_pair_kernel, , false, true),
    PSO_TABLE(async_pair_kernel, , true, true)};
const Kernel kQueuePair[2][kFitnessCount][kRuleCount] = {
    {PSO_BUILTINS(queue_pair_kernel, , false)},
    {PSO_BUILTINS(queue_pair_kernel, , true)}};
#endif

Kernel pick(const Kernel (*table)[kRuleCount], int fit, int rule,
            int fits = kTableFits) {
  if (!table || fit < 0 || fit >= fits || rule < 0 || rule >= kRuleCount)
    return nullptr;
  return table[fit][rule];
}

// A fused launch's table: the lane path's (lanes 1) or, in the bfloat16
// library, the pair path's (lanes 2); null for any other.
const Kernel (*fused_table(bool grid, bool cl, int lanes))[kRuleCount] {
#ifdef PSO_T_BF16
  if (lanes == 2) return (grid ? kFusedPairGrid : kFusedPairBlock)[cl];
#endif
  return lanes == 1 ? (grid ? kFusedGrid : kFusedBlock)[cl] : nullptr;
}

// An async launch's table, as fused_table.
const Kernel (*async_table(bool lbest, bool cl, int lanes))[kRuleCount] {
#ifdef PSO_T_BF16
  if (lanes == 2) return (lbest ? kAsyncPairLbest : kAsyncPair)[cl];
#endif
  return lanes == 1 ? (lbest ? kAsyncLbest : kAsync)[cl] : nullptr;
}

// A queue launch's table, as fused_table.
const Kernel (*queue_table(bool cl, int lanes))[kRuleCount] {
#ifdef PSO_T_BF16
  if (lanes == 2) return kQueuePair[cl];
#endif
  return lanes == 1 ? kQueue[cl] : nullptr;
}

// The pair path takes an even block (so an even swarm, whose columns start
// even) and pos, vel, pbest_pos and pbest_fit on 4 bytes.
bool bad_pairs(int lanes, int n, int bn, const void* pos, const void* vel,
               const void* pbp, const void* pbf) {
  if (lanes != 2) return false;
  const uintptr_t a = (uintptr_t)pos | (uintptr_t)vel | (uintptr_t)pbp |
                      (uintptr_t)pbf;
  return n % 2 || bn % 2 || (a & 3u);
}

// att and the four bound rows of the CTA's slice; with a cluster, the
// partial objectives of both parities ([2][3][bn]).
size_t smem_bytes(int d, int csize, int bn) {
  const size_t ls = (size_t)((d + csize - 1) / csize);
  return (5 * ls + (csize > 1 ? 6 * (size_t)bn : 0)) * sizeof(float);
}

cudaError_t prepare(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

Params<Store> make_params(Store* pos, Store* vel, Store* pbp, Store* pbf,
                          Store* gp, Store* gf, const float* bounds,
                          const int* member_fit, const int* fids,
                          const unsigned* seeds, const unsigned* its,
                          unsigned seed0, unsigned it00, int n, int d, int bn,
                          int s_cnt, int iters, float w, float c1, float c2,
                          float k0, float k1, float k2) {
  Params<Store> p = {};
  p.pos = pos; p.vel = vel; p.pbp = pbp; p.pbf = pbf; p.gp = gp; p.gf = gf;
  p.bounds = bounds; p.member_fit = member_fit; p.fids = fids;
  p.seeds = seeds; p.its = its; p.seed0 = seed0; p.it00 = it00;
  p.n = n; p.d = d; p.bn = bn; p.nb = n / bn; p.s_cnt = s_cnt;
  p.ld = s_cnt * n;
  p.iters = iters; p.chunk = iters; p.csize = 1;
  p.w = w; p.c1 = c1; p.c2 = c2; p.k0 = k0; p.k1 = k1; p.k2 = k2;
  return p;
}

// A CTA's threads: a particle each (lanes 1) or a pair each (lanes 2), at
// most kMaxThreads.
int threads_for(int bn, int lanes = 1) {
  const int t = bn / lanes;
  return t < kMaxThreads ? t : kMaxThreads;
}

bool bad_shape(int n, int d, int bn, int s_cnt) {
  return n <= 0 || d <= 0 || bn <= 0 || n % bn || s_cnt <= 0 ||
         (long long)s_cnt * n >= (1ll << 31);
}

// A cluster of csize CTAs (at most 8, Hopper's portable size) takes one
// particle a thread (bn <= 512) and at least one dimension a CTA.
bool bad_cluster(int csize, int d, int bn) {
  if (csize == 1) return false;
  return csize < 1 || csize > 8 || bn > kMaxThreads || csize > d;
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int threads, size_t smem,
                                  cudaStream_t stream, int csize, bool coop,
                                  cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)csize;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.numAttrs = 1;
  if (coop) {
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  cfg.attrs = attrs;
  return cfg;
}

// One launch of `blocks` CTAs: with csize > 1 in clusters of csize through
// cudaLaunchKernelEx (cooperative too when coop), else the classic way. A
// refused launch is returned, never retried another way.
cudaError_t launch(Kernel k, unsigned blocks, int threads, size_t smem,
                   cudaStream_t stream, int csize, bool coop,
                   Params<Store>* p) {
  void* args[] = {p};
  if (csize > 1) {
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg =
        cluster_config(blocks, threads, smem, stream, csize, coop, attrs);
    return cudaLaunchKernelExC(&cfg, (const void*)k, args);
  }
  if (coop)
    return cudaLaunchCooperativeKernel((const void*)k, dim3(blocks),
                                       dim3((unsigned)threads), args, smem,
                                       stream);
  k<<<blocks, threads, smem, stream>>>(*p);
  return cudaSuccess;
}

// How many CTAs (csize 1) or clusters of csize CTAs of kernel k can be
// resident at once.
cudaError_t resident(Kernel k, int bn, int d, int csize, int* out) {
  const size_t smem = smem_bytes(d, csize, bn);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return err;
  if (csize > 1) {
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg = cluster_config(
        (unsigned)csize, threads_for(bn), smem, nullptr, csize, false, attrs);
    return cudaOccupancyMaxActiveClusters(out, (const void*)k, &cfg);
  }
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      threads_for(bn), smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return err;
}

}  // namespace

extern "C" {

// How many fused-kernel CTAs (csize 1) or clusters of csize CTAs of this
// configuration can be resident at once: a cooperative launch needs all of
// them, so a wave holds that many divided by the blocks of a swarm. `fit`
// is an objective id, or 6 for the heterogeneous kernel.
int pso_fused_resident(int fit, int rule, int bn, int d, int csize,
                       int* out) {
  if (bad_cluster(csize, d, bn)) return (int)cudaErrorInvalidValue;
  const Kernel k = pick(kFusedGrid[csize > 1], fit, rule);
  if (!k) return (int)cudaErrorInvalidValue;
  return (int)resident(k, bn, d, csize, out);
}

// The fewest clusters of csize CTAs that any fused or async kernel of this
// library (every objective, the heterogeneous one where the library has
// it, every rule) keeps resident at (bn, d):
// the card's capacity on which the wrapper chooses csize, the same for
// every kernel so that the choice depends on the shape alone.
int pso_cluster_capacity(int bn, int d, int csize, int* out) {
  if (csize < 2 || bad_cluster(csize, d, bn))
    return (int)cudaErrorInvalidValue;
  int least = -1;
  const Kernel (*tables[])[kRuleCount] = {kFusedGrid[1], kAsync[1]};
  for (const auto table : tables)
    for (int f = 0; f < kTableFits; ++f)
      for (int r = 0; r < kRuleCount; ++r) {
        int got = 0;
        const cudaError_t err = resident(table[f][r], bn, d, csize, &got);
        if (err != cudaSuccess) return (int)err;
        least = least < 0 || got < least ? got : least;
      }
  *out = least;
  return (int)cudaSuccess;
}

// `iters` fused iterations of swarms s0 .. s0+count-1 of a batch of s_cnt,
// each particle block on a cluster of csize CTAs (1: one CTA): one
// cooperative launch of count*(n/bn)*csize CTAs, or, with one block a
// swarm, a normal launch of count*csize. Null seeds/its take seed0/it00
// (one swarm); non-null counts [s_cnt,3] gets each swarm's events added.
// lanes 1 takes a particle a thread; 2, in the bfloat16 library, the pair
// path (n and bn even, pos, vel, pbp and pbf on 4 bytes; bad_pairs).
int pso_fused_launch(Store* pos, Store* vel, Store* pbp, Store* pbf,
                     Store* gp, Store* gf, const float* bounds,
                     const int* member_fit, const int* fids,
                     const unsigned* seeds,
                     const unsigned* its, unsigned long long* keys,
                     Store* cand, int* counts, int n, int d, int bn,
                     int s_cnt, int s0, int count, int iters, int csize,
                     unsigned seed0, unsigned it00, int fit, int rule,
                     float w, float c1, float c2, float k0, float k1,
                     float k2, int lanes, void* stream) {
  if (bad_shape(n, d, bn, s_cnt) || bad_cluster(csize, d, bn) || s0 < 0 ||
      count <= 0 || s0 + count > s_cnt ||
      (fit == kHetero && !(member_fit && fids)) ||
      (!(seeds && its) && s_cnt != 1) ||
      bad_pairs(lanes, n, bn, pos, vel, pbp, pbf))
    return (int)cudaErrorInvalidValue;
  const bool grid = n / bn > 1;
  const Kernel k = pick(fused_table(grid, csize > 1, lanes), fit, rule);
  if (!k) return (int)cudaErrorInvalidValue;
  Params<Store> p =
      make_params(pos, vel, pbp, pbf, gp, gf, bounds, member_fit, fids, seeds,
                  its, seed0, it00, n, d, bn, s_cnt, iters, w, c1, c2, k0, k1,
                  k2);
  p.keys = keys;
  p.cand = cand;
  p.counts = counts;
  p.s0 = s0;
  p.csize = csize;
  const size_t smem = smem_bytes(d, csize, bn);
  cudaError_t err = prepare(k, smem);
  if (err == cudaSuccess)
    err = launch(k, (unsigned)(count * p.nb * csize), threads_for(bn, lanes),
                 smem, (cudaStream_t)stream, csize, grid, &p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `iters` async iterations of all s_cnt swarms, `chunk` iterations between
// boundaries, each particle block on a cluster of csize CTAs (1: one CTA):
// a normal launch of s_cnt*(n/bn)*csize CTAs. `it_off` is added to every
// swarm's iteration counter. Null seeds/its take seed0/it00 (one swarm);
// non-null counts [s_cnt,3] gets each swarm's events added. topo 0 is the
// star (slot_seq null); 1 (ring) and 2 (von Neumann, on a grid_r x grid_c
// torus of the n/bn blocks) fold neighbours, with slot_seq [s_cnt*n/bn]
// even (zeroed) sequence counters. lanes as in pso_fused_launch.
int pso_async_launch(Store* pos, Store* vel, Store* pbp, Store* pbf,
                     Store* gp, Store* gf, const float* bounds,
                     const int* member_fit, const int* fids,
                     const unsigned* seeds,
                     const unsigned* its, Store* lp, Store* lf,
                     unsigned* lock, int* counts, unsigned* slot_seq, int n,
                     int d, int bn, int s_cnt, int iters, int chunk,
                     int csize, int topo, int grid_r, int grid_c,
                     unsigned it_off, unsigned seed0, unsigned it00, int fit,
                     int rule, float w, float c1, float c2, float k0,
                     float k1, float k2, int lanes, void* stream) {
  if (bad_shape(n, d, bn, s_cnt) || bad_cluster(csize, d, bn) || chunk <= 0 ||
      iters % chunk || (fit == kHetero && !(member_fit && fids)) ||
      (!(seeds && its) && s_cnt != 1) || topo < 0 || topo > kVonNeumann ||
      (topo != 0) != (slot_seq != nullptr) ||
      (topo == kVonNeumann &&
       (grid_r < 1 || grid_c < 1 || grid_r * grid_c != n / bn)) ||
      bad_pairs(lanes, n, bn, pos, vel, pbp, pbf))
    return (int)cudaErrorInvalidValue;
  const Kernel k = pick(async_table(topo != 0, csize > 1, lanes), fit, rule);
  if (!k) return (int)cudaErrorInvalidValue;
  Params<Store> p =
      make_params(pos, vel, pbp, pbf, gp, gf, bounds, member_fit, fids, seeds,
                  its, seed0, it00, n, d, bn, s_cnt, iters, w, c1, c2, k0, k1,
                  k2);
  p.lp = lp;
  p.lf = lf;
  p.lock = lock;
  p.counts = counts;
  p.chunk = chunk;
  p.it_off = it_off;
  p.csize = csize;
  p.slot_seq = slot_seq;
  p.topo = topo;
  p.grid_r = grid_r;
  p.grid_c = grid_c;
  const size_t smem = smem_bytes(d, csize, bn);
  cudaError_t err = prepare(k, smem);
  if (err == cudaSuccess)
    err = launch(k, (unsigned)s_cnt * p.nb * csize, threads_for(bn, lanes),
                 smem, (cudaStream_t)stream, csize, false, &p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One queue-algorithm iteration (it00 + 1) of one swarm, each particle
// block on a cluster of csize CTAs (1: one CTA): a normal launch of
// (n/bn)*csize CTAs that updates pos/vel/pbp/pbf in place and writes
// aux_fit[n/bn], aux_idx[n/bn]; gp [D] and gf [1] are only read. lanes as
// in pso_fused_launch.
int pso_queue_launch(Store* pos, Store* vel, Store* pbp, Store* pbf,
                     const Store* gp, const Store* gf, const float* bounds,
                     Store* aux_fit, int* aux_idx, int n, int d, int bn,
                     int csize, unsigned seed0, unsigned it00, int fit,
                     int rule, float w, float c1, float c2, float k0,
                     float k1, float k2, int lanes, void* stream) {
  const Kernel k =
      pick(queue_table(csize > 1, lanes), fit, rule, kFitnessCount);
  if (!k || bad_shape(n, d, bn, 1) || bad_cluster(csize, d, bn) ||
      bad_pairs(lanes, n, bn, pos, vel, pbp, pbf))
    return (int)cudaErrorInvalidValue;
  Params<Store> p = make_params(
      pos, vel, pbp, pbf, const_cast<Store*>(gp), const_cast<Store*>(gf),
      bounds, nullptr, nullptr, nullptr, nullptr, seed0, it00, n, d, bn, 1, 1,
      w, c1, c2, k0, k1, k2);
  p.aux_fit = aux_fit;
  p.aux_idx = aux_idx;
  p.csize = csize;
  const size_t smem = smem_bytes(d, csize, bn);
  cudaError_t err = prepare(k, smem);
  if (err == cudaSuccess)
    err = launch(k, (unsigned)(p.nb * csize), threads_for(bn, lanes), smem,
                 (cudaStream_t)stream, csize, false, &p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Every block's neighbour ids under topology topo (1 ring, 2 von Neumann
// on a rows x cols torus) into out [nb, 2 or 4], as async_kernel's lbest
// folds compute them.
int pso_neighbor_ids(int nb, int topo, int rows, int cols, int* out,
                     void* stream) {
  if (nb < 1 || (topo != kRing && topo != kVonNeumann) || !out ||
      (topo == kVonNeumann && (rows < 1 || cols < 1 || rows * cols != nb)))
    return (int)cudaErrorInvalidValue;
  neighbors_kernel<<<(nb + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      nb, topo, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
