// Hand-written Hopper (sm_90a) kernels of the split path: one PSO
// iteration as two launches around the user's own torch operators, for
// every Problem that is not one of the six unconstrained built-ins
// (custom objectives, kernel_fn, and the penalty, projection and repair
// constraint modes). They port the converted forms of the Pallas kernels
// of src/repro/kernels/pso_step.py (their objective through
// dmajor_adapter or kernel_fn, the projection of kernel_projection after
// the clip, the Deb fold of kernel_violation/_pbest_improved), which trace
// the user's jnp functions into their bodies; a CUDA kernel cannot run a
// Python callable, so the iteration is split where those functions run:
//
//   split_advance_kernel<R>    pos and vel against an attractor column,
//                              clipped to the box; no fitness (one thread
//                              an element; in bfloat16
//                              split_advance_bf16_kernel<R, L>, 8 or 1
//                              lanes a thread, computed on lane pairs).
//   -- the caller's torch step: projection (written back into pos), the
//      objective (max_fn or kernel_fn), the violation where Deb applies --
//   split_fold_publish_kernel  the pbest fold (raw fitness, or Deb's rule
//                              on fit/viol against the carried pbest
//                              violation), the paper's intra-block queue,
//                              and the cross-block stage: the CTA that
//                              arrives last at its swarm's counter
//                              publishes (the fused mode's gbest from the
//                              folded keys, the async mode's
//                              publish-and-pull or flush; under an lbest
//                              topology the pull is each block's
//                              neighbourhood best of the locals).
//
// In stream order that is synchronous PPSO: every block reads iteration
// t-1's gbest, as the fused kernel of pso_step.cu does with several
// blocks. This file shares with pso_step.cu only bf16x2.cuh, the bfloat16
// libraries' packed instructions and rule on lane pairs: the other device
// functions it needs (the counter hash, the three rules, the queue keys)
// are copied here, with the same __f*_rn chains.
//
// What bounds them on an H100: the advance reads pos, vel and pbest_pos
// and writes pos and vel, 20 bytes a particle-dimension (20*N*D for a
// swarm: 78.6 MB at N=32768, D=120, beyond the 50 MB L2), against 42
// integer and 16 float operations an element (the two counter-hash draws
// and the rule), so at large N*D it is bound by bytes, and one thread an
// element with the particle index fastest keeps every access coalesced. In
// bfloat16 the bytes halve and what the kernel issues sets its time
// (split_advance_bf16_kernel's note).
// The fold reads 8 to 16 bytes a particle (fit and pbest_fit, plus the
// violations under Deb's rule) and, for each particle that improved,
// writes its pbest fitness and copies its column: 4 + 8*D bytes (pos read,
// pbest_pos written), so two iterations into a run, when most particles
// still improve, the copies are nearly all of its bytes (23 MB at
// N=32768, D=120) and the fold is bound by bytes; the publish moves one
// column a swarm. The card moves those bytes in 32-byte sectors: where a
// quarter of the particles do not improve, nearly every sector of pos is
// read and every sector of pbest_pos is written in part, which needs its
// old contents (a fill from HBM). What the design does about it: each
// particle block runs on a cluster of C = 1 or 2 CTAs (fold_cluster_size
// in pso_split.py: two where the launch still keeps at most one CTA an
// SM), every rank decides `improved` for the whole block itself, and
// each copies its own slice of the D rows; a
// rank compacts the block's groups of four lanes with an improving lane
// into shared memory with a warp ballot, then all its threads stride over
// (row, group) pairs, four pairs in flight a thread, each group's four
// lanes of pos in one access merged with pbest_pos's where not all four
// lanes improved, so every write is whole: a float4, 16 bytes, in float;
// in bfloat16 the same groups of four lanes in 8-byte accesses (a uint2,
// two lanes a word), which keeps the ballot, the masks and the
// compaction of the float kernel (a lane at a time where the rows are not
// aligned to four lanes). The queue's 64-bit key is reduced
// over each warp by shuffles, then one shared atomicMax a warp. The
// cross-block stage needs no launch of its own and no co-resident CTAs:
// no CTA ever waits for another; the last to arrive publishes (the
// paper's point: threads update a shared result with atomics rather than
// in a separate reduction stage), and the rank-0 CTA copies its rows
// while its arrival is in flight, so the arrival waits for no copy. At
// small swarms the two launches and the host's torch calls, not the card,
// set the time of an iteration (chip_smoke.py phase 6).
//
// Layout: D-major, [D, S*N] with the particle index fastest; swarm s owns
// columns [s*N, (s+1)*N). gp [D, S], gf [S]; the async mode's block-local
// bests lp [D, S*nb], lf [S*nb]. Bounds are the wrappers' member table
// [members, 4, D] (lo, hi, max_v, span) and fids[S] (null: member 0).
// seeds[S] and its[S] are uint32 counters; the advance of iteration
// its[s] + it_off + 1 draws at element index particle*D + dim, local to the
// swarm, as every engine of the port does.
//
// Storage types: the swarm's arrays (pos, vel, pbest, the fitnesses and
// violations, the bests, the async locals, aux_fit and the lbest scratch)
// are of type T, float, or __nv_bfloat16 in the library built from this
// source with -DPSO_T_BF16 (kernels/_build.py VARIANTS); the bounds table
// is float in both, holding values of T. A value is widened to float when
// it is loaded. In bfloat16 the advance (split_advance_bf16_kernel)
// computes what the reference's kernels compute in that dtype (ROADMAP,
// parity contract, "bfloat16"): every operation's result rounded to
// bfloat16, the coefficients the host's rounded values, the draw (h >> 8)
// rounded to bfloat16 before its exact scaling (so it may be 1.0). The
// fold only compares widened values (exact) and copies: the queue keys come
// from the widened fitness, so the order and the first-lane tie-break are
// float's. For float, widen is the identity, and the float kernels compute
// what they computed before T was a parameter.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kStreamR1 = 2u, kStreamR2 = 3u;
constexpr int kFoldThreads = 512;
constexpr int kAdvanceThreads = 256;
// (row, entry) pairs a thread of the fold's pbest copies has in flight:
// four-lane entries (Quad<T>) and single-lane ones.
constexpr int kCopyUnroll4 = 4, kCopyUnroll1 = 8;
// The largest cluster a particle block runs on (FOLD_CLUSTERS in
// pso_split.py: the sizes chip_smoke.py phase 6c measures).
constexpr int kMaxCluster = 2;

// Fold modes (kernels/pso_split.py MODES).
constexpr int kQueue = 0, kFused = 1, kAsync = 2;
// The async publish's per-swarm action (2: publish only, the end of a
// call).
constexpr int kActNone = 0, kActSync = 1;

struct Coef { float w, c1, c2, k0, k1, k2; };   // values of T

// ---- storage types (the header's "Storage types") ---------------------------
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
// A load past L1 (what other blocks wrote in this launch), as T.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Four lanes of T in one access, and one lane's bits: a float4 and float,
// or for bfloat16 a uint2 (two lanes a word, the lower lane in the low
// half) and unsigned short. merge keeps the lanes of v whose bit is set in
// m and takes the others from p.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using V = float4;
  using S = float;
  __device__ static __forceinline__ V merge(V v, const V& p, int m) {
    v.x = m & 1 ? v.x : p.x;
    v.y = m & 2 ? v.y : p.y;
    v.z = m & 4 ? v.z : p.z;
    v.w = m & 8 ? v.w : p.w;
    return v;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  using S = unsigned short;
  __device__ static __forceinline__ V merge(V v, const V& p, int m) {
    const unsigned m0 =
        (m & 1 ? 0x0000FFFFu : 0u) | (m & 2 ? 0xFFFF0000u : 0u);
    const unsigned m1 =
        (m & 4 ? 0x0000FFFFu : 0u) | (m & 8 ? 0xFFFF0000u : 0u);
    v.x = (v.x & m0) | (p.x & ~m0);
    v.y = (v.y & m1) | (p.y & ~m1);
    return v;
  }
};

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

// Deb's rule (core/constraints.py deb_improved), on widened values.
__device__ __forceinline__ bool deb_improved(float fn, float vn, float fo,
                                             float vo) {
  const bool a = vn <= 0.0f, b = vo <= 0.0f;
  return (a && !b) || (a && b && fn > fo) || (!a && !b && vn < vo);
}

// ---- split_advance_kernel --------------------------------------------------
// One thread an element (k, col) of the [D, S*N] arrays, grid-stride:
// neighbouring threads touch neighbouring columns of one row. The attractor
// of column col is column col / gdiv of the attractor array (gdiv = N: gp, one
// column a swarm; gdiv = bn: lp, one column a particle block). The float
// library's advance; the bfloat16 library's is split_advance_bf16_kernel.
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

#ifdef PSO_T_BF16
// ---- the bfloat16 advance: split_advance_bf16_kernel ------------------------
// What bounds the advance in each dtype. In float it moves 20 bytes an
// element against ~42 integer operations (the counter hash) and 16 float
// ones, so bytes bound it (23.5 us at D=120, N=32768). In bfloat16 it moves
// 10 bytes (11.7 us) against the same hash (~9.9 us on the integer pipe,
// half the float rate), so what the kernel issues beside the hash decides
// its time. Written as the float kernel is, one thread an element with each
// of its 12 results rounded to bfloat16, it would issue far more: a 64-bit
// division and the swarm's counters and bound rows for every element, a
// 2-byte access a lane, and two conversions (float to bfloat16 and back)
// around each rounding, on the conversion pipe (16 a clock an SM). What
// this kernel does about it:
//   * a CTA takes one row k (grid y, strided past 65535) and a stretch of
//     columns; the row's bounds, the swarm's counters and the hash's
//     per-swarm terms are loaded or computed once a thread, the element
//     index's hash terms advance by a constant from lane to lane, and no
//     64-bit division is left;
//   * L = 8 lanes a thread: pos, vel and pbest_pos in one 16-byte access
//     each (four lane pairs), all issued before the hash; the attractor
//     column is one value for the tile (gdiv % 8 == 0). L = 1, a lane a
//     thread, takes what that cannot: gdiv % 8 != 0 (which includes
//     N % 8 != 0), an operand not on 16 bytes, a member table; and the
//     small launches, where eight lanes a thread leave too few threads to
//     hide their latency (the caller, kernels/pso_split.py advance_lanes,
//     picks);
//   * the rule on lane pairs in sm_90's packed instructions (bf2,
//     bf16x2.cuh):
//     one instruction, and one rounding, for two lanes' operation, no
//     conversion but the draws' one pair rounding.
// It computes split_advance_plain (kernels/pso_split.py) in bfloat16 bit for
// bit: the float kernel's operations in the same order, each result rounded
// once to bfloat16 (chip_smoke.py 16a; pso_split_bf16_check proves the
// premise below).

// The packed instructions (bf2), the draws as lane pairs and the rule on lane
// pairs (advance2), shared with pso_step.cu's bfloat16 library.
#include "bf16x2.cuh"

// L = 8 or 1 lanes a thread (the note above): thread t of CTA (bx, by) takes
// columns [col, col + L) of rows by, by + gridDim.y, ..., col = (bx *
// blockDim.x + t) * L. gld = S*N / gdiv, the attractor's row length.
template <int R, int L>
__global__ void __launch_bounds__(kAdvanceThreads) split_advance_bf16_kernel(
    __nv_bfloat16* __restrict__ pos, __nv_bfloat16* __restrict__ vel,
    const __nv_bfloat16* __restrict__ pbp,
    const __nv_bfloat16* __restrict__ attractor,
    const float* __restrict__ bounds, const int* __restrict__ fids,
    const uint32_t* __restrict__ seeds, const uint32_t* __restrict__ its,
    int n, int d, int s_cnt, int gdiv, int gld, uint32_t it_off, Coef cf) {
  using U = unsigned short;
  const int ld = s_cnt * n;
  const long long c0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * L;
  if (c0 >= ld) return;
  const int col = (int)c0;
  // with L = 8 the tile lies in one swarm (N % 8 == 0) and one attractor
  // column (gdiv % 8 == 0)
  const int s = s_cnt == 1 ? 0 : col / n;
  const int i = col - s * n;
  const int acol = gdiv == n ? s : col / gdiv;
  const uint32_t it = its[s] + it_off + 1u;
  const uint32_t hs = seeds[s] * 0x9E3779B9u + it * 0x85EBCA6Bu;
  const uint32_t h1 = hs + kStreamR1 * 0xC2B2AE35u;
  const uint32_t h2 = hs + kStreamR2 * 0xC2B2AE35u;
  const uint32_t ts = it * 0xC2B2AE35u;
  // a lane further: the element index grows by d
  const uint32_t step_a = (uint32_t)d * 0x27D4EB2Fu;
  const uint32_t step_t = (uint32_t)d * 0x9E3779B9u;
  const float* bnd = bounds + (size_t)(fids ? fids[s] : 0) * 4 * d;
  const Coef2 p{bboth(cf.w), bboth(cf.c1), bboth(cf.c2), cf.k0, cf.k1, cf.k2};
  const U* att = reinterpret_cast<const U*>(attractor);
  for (int k = blockIdx.y; k < d; k += gridDim.y) {
    const size_t e = (size_t)k * ld + col;
    const bf2 g = bboth(att[(size_t)k * gld + acol]);
    const bf2 mv = bboth(bnd[2 * d + k]);
    const Row2 b{bboth(bnd[k]), bboth(bnd[d + k]), mv, mv ^ 0x80008000u,
                 bboth(bnd[3 * d + k])};
    const uint32_t idx = (uint32_t)i * (uint32_t)d + (uint32_t)k;
    uint32_t a = idx * 0x27D4EB2Fu, t = idx * 0x9E3779B9u + ts;
    if constexpr (L == 8) {
      const uint4 x4 = *reinterpret_cast<const uint4*>(pos + e);
      const uint4 v4 =
          R == 1 ? uint4{} : *reinterpret_cast<const uint4*>(vel + e);
      const uint4 p4 = *reinterpret_cast<const uint4*>(pbp + e);
      bf2 x[4] = {x4.x, x4.y, x4.z, x4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
      const bf2 pb[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u1a = draw24(h1 + a, t), u2a = draw24(h2 + a, t);
        a += step_a;
        t += step_t;
        const uint32_t u1b = draw24(h1 + a, t), u2b = draw24(h2 + a, t);
        a += step_a;
        t += step_t;
        advance2<R>(p, draw_pair(u1a, u1b), draw_pair(u2a, u2b), x[j], v[j],
                    pb[j], g, b);
      }
      *reinterpret_cast<uint4*>(pos + e) = uint4{x[0], x[1], x[2], x[3]};
      if (R != 1)   // sso passes the velocity through: vel is left as it is
        *reinterpret_cast<uint4*>(vel + e) = uint4{v[0], v[1], v[2], v[3]};
    } else {        // one lane, in both halves of the pair
      const U* pu = reinterpret_cast<const U*>(pos);
      bf2 x = bboth(pu[e]);
      bf2 v = R == 1 ? 0u : bboth(reinterpret_cast<const U*>(vel)[e]);
      const bf2 pb = bboth(reinterpret_cast<const U*>(pbp)[e]);
      const uint32_t u1 = draw24(h1 + a, t), u2 = draw24(h2 + a, t);
      advance2<R>(p, draw_pair(u1, u1), draw_pair(u2, u2), x, v, pb, g, b);
      reinterpret_cast<U*>(pos)[e] = (U)x;
      if (R != 1) reinterpret_cast<U*>(vel)[e] = (U)v;
    }
  }
}

// ---- the premise, on the card: pso_split_bf16_check ------------------------
// Each packed instruction above on every operand pair against the float
// operation rounded once, the plain version's model: mul, add and sub over
// all 2^32 pairs of bfloat16 values (a, b) against
// __float2bfloat16_rn(__f*_rn(a, b)); max and min
// against fmaxf and fminf; the draws' pair rounding over every (h >> 8)
// (2^24) against __float2bfloat16_rn of each. Equal: the same 16 bits, or
// NaN on both sides whatever its sign and payload (the kernel's operands are
// never NaN); a signed zero is compared by its bits, so max(-0, +0) must
// pick the zero fmaxf picks.
constexpr int kOpMul = 0, kOpAdd = 1, kOpSub = 2, kOpMax = 3, kOpMin = 4,
              kOpDraw = 5, kOps = 6;

__device__ __forceinline__ bool same_bf16(uint32_t a, uint32_t b) {
  return a == b || ((a & 0x7FFFu) > 0x7F80u && (b & 0x7FFFu) > 0x7F80u);
}

template <int OP>
__device__ __forceinline__ uint32_t float_form(uint32_t a, uint32_t b) {
  const float x = __uint_as_float(a << 16), y = __uint_as_float(b << 16);
  float r;
  if (OP == kOpMul) r = __fmul_rn(x, y);
  else if (OP == kOpAdd) r = __fadd_rn(x, y);
  else if (OP == kOpSub) r = __fsub_rn(x, y);
  else if (OP == kOpMax) r = fmaxf(x, y);
  else r = fminf(x, y);
  return __bfloat16_as_ushort(__float2bfloat16_rn(r));
}

template <int OP>
__device__ __forceinline__ bf2 packed_form(bf2 a, bf2 b) {
  if (OP == kOpMul) return bmul(a, b);
  if (OP == kOpAdd) return badd(a, b);
  if (OP == kOpSub) return bsub(a, b);
  if (OP == kOpMax) return bmax(a, b);
  return bmin(a, b);
}

// out[0] += mismatches, out[1] = min(out[1], the first mismatch's index:
// a << 16 | b, or the draw's value), out[2] += the pairs checked.
template <int OP>
__global__ void __launch_bounds__(256) split_bf16_check_kernel(
    unsigned long long* out) {
  // packed pair p: lanes (a, b) and (a, b + 1), a = p >> 15, b = 2p mod 2^16;
  // the draws: values 2p and 2p + 1
  const uint32_t total = OP == kOpDraw ? 1u << 23 : 1u << 31;
  unsigned long long bad = 0, first = ~0ull, seen = 0;
  for (uint32_t q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    uint32_t got, want0, want1, id0;
    if (OP == kOpDraw) {
      id0 = 2 * q;
      got = bpack((float)id0, (float)(id0 + 1));
      want0 = __bfloat16_as_ushort(__float2bfloat16_rn((float)id0));
      want1 = __bfloat16_as_ushort(__float2bfloat16_rn((float)(id0 + 1)));
    } else {
      const uint32_t a = q >> 15, b = (2 * q) & 0xFFFFu;
      id0 = (a << 16) | b;
      got = packed_form<OP>(a * 0x10001u, b | ((b + 1) << 16));
      want0 = float_form<OP>(a, b);
      want1 = float_form<OP>(a, b + 1);
    }
    seen += 2;
    if (!same_bf16(got & 0xFFFFu, want0)) {
      ++bad;
      first = first < id0 ? first : id0;
    }
    if (!same_bf16(got >> 16, want1)) {
      ++bad;
      first = first < id0 + 1 ? first : id0 + 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_xor_sync(0xFFFFFFFFu, bad, o);
    seen += __shfl_xor_sync(0xFFFFFFFFu, seen, o);
    const unsigned long long f = __shfl_xor_sync(0xFFFFFFFFu, first, o);
    first = f < first ? f : first;
  }
  if ((threadIdx.x & 31) == 0) {
    if (bad) atomicAdd(out, bad);
    if (first != ~0ull) atomicMin(out + 1, first);
    atomicAdd(out + 2, seen);
  }
}
#endif  // PSO_T_BF16

// ---- split_fold_publish_kernel --------------------------------------------
// Everything the kernel reads and writes; null pointers for what a mode
// does not use (kernels/pso_split.py fold_publish). T: the storage type.
template <typename T>
struct FoldArgs {
  const T* pos;
  T* pbp;
  T* pbf;
  T* pbv;
  const T* fit;
  const T* viol;
  T* gp;
  T* gf;
  T* lp;
  T* lf;
  unsigned long long* keys;
  T* aux_fit;
  int* aux_idx;
  int* counts;
  const int* act;
  int* arrive;
  T* scratch;
  int n, d, bn, s_cnt, mode, topo, rows, cols, csize;
  int vec4;                 // the copies four lanes at a time (Quad<T>)
};

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync(int csize) {
  if (csize > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Rows [k0, k1) of the block's pbest copies (pos into pbp), from the `m`
// entries s_cols[0..m) the ballot compacted: (lane << 4) | its mask of
// improving lanes. V4: an entry is four lanes, one Quad<T> access a row,
// and where not all four improved the pbest lanes are read too and
// merged, so every write is whole; else an entry is one lane. The
// CTA's threads stride over the (row, entry) pairs, the entry fastest, so
// a warp's neighbouring threads touch neighbouring columns of one row;
// several pairs' loads are issued before their stores.
template <bool V4, typename T>
__device__ __forceinline__ void copy_columns(const FoldArgs<T>& a,
                                             const int* s_cols, int m,
                                             int base, int k0, int k1,
                                             size_t ld) {
  using V = typename Quad<T>::V;
  using S = typename Quad<T>::S;
  constexpr int U = V4 ? kCopyUnroll4 : kCopyUnroll1;
  const int rows = k1 - k0, nt = blockDim.x;
  if (m == 0 || rows <= 0) return;
  int j = threadIdx.x % m, k = threadIdx.x / m;
  const int dj = nt % m, dk = nt / m;
  while (k < rows) {
    V v[U], p[U];
    size_t o[U];
    int msk[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ent = s_cols[j];
      in[u] = k < rows;
      msk[u] = ent & 15;
      o[u] = (size_t)(k0 + k) * ld + base + (ent >> 4);
      if (in[u]) {
        if (V4) {
          v[u] = *reinterpret_cast<const V*>(a.pos + o[u]);
          if (msk[u] != 15)
            p[u] = *reinterpret_cast<const V*>(a.pbp + o[u]);
        } else {
          v[u].x = *reinterpret_cast<const S*>(a.pos + o[u]);
        }
      }
      j += dj;
      k += dk;
      if (j >= m) {
        j -= m;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!in[u]) continue;
      if (V4) {
        if (msk[u] != 15) v[u] = Quad<T>::merge(v[u], p[u], msk[u]);
        *reinterpret_cast<V*>(a.pbp + o[u]) = v[u];
      } else {
        *reinterpret_cast<S*>(a.pbp + o[u]) = (S)v[u].x;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_rows(const FoldArgs<T>& a,
                                          const int* s_cols, int m, int base,
                                          int k0, int k1, size_t ld) {
  if (a.vec4)
    copy_columns<true, T>(a, s_cols, m, base, k0, k1, ld);
  else
    copy_columns<false, T>(a, s_cols, m, base, k0, k1, ld);
}

// The cross-block stage of swarm s, run by the rank-0 CTA of the swarm's
// last block to arrive, after every block's fold. Fused mode: the winner
// of keys[s] (the best lane of the iteration that beat gf[s], every
// block's key folded) becomes gbest, and keys[s] is cleared for the next
// iteration. Async mode, act[s]: kActSync publishes the best local (first
// on ties) into gbest where it beats it, then pulls gbest into every
// local; 2 publishes only (the end of a call); kActNone leaves the swarm
// alone (core/pso.py _sync_point). Under an lbest topology (topo 1 or 2)
// the pull of kActSync is core/topology.py's block_neighbor_best: every
// local becomes the best of itself and its neighbours (self first, strict
// >), all read before any is written, so the swarm's locals are first
// copied to `scratch` ([D+1, S*nb]: lp's rows, then lf) and read from
// there. What other blocks wrote in this launch (keys, lp, lf) is read
// from L2 (ldcg): a line of it may sit stale in this SM's L1.
template <typename T>
__device__ void publish_swarm(const FoldArgs<T>& a, int s, int nb,
                              unsigned long long* s_key) {
  const int n = a.n, d = a.d, s_cnt = a.s_cnt;
  const size_t ld = (size_t)s_cnt * n;
  if (a.mode == kFused) {
    const unsigned long long key = __ldcg(a.keys + s);
    __syncthreads();                   // every thread has read keys[s]
    if (!key) return;
    const int wc = s * n + key_index(key);
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      a.gp[(size_t)k * s_cnt + s] = a.pos[(size_t)k * ld + wc];
    if (threadIdx.x == 0) {
      a.gf[s] = a.fit[wc];
      a.keys[s] = 0ull;
    }
    return;
  }
  const int act = a.act[s];
  if (act == kActNone) return;
  const size_t lld = (size_t)s_cnt * nb;
  T* lp = a.lp;
  T* lf = a.lf;
  if (threadIdx.x == 0) *s_key = 0ull;
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += blockDim.x)
    atomicMax(s_key, make_key(widen(ldcg(lf + s * nb + j)), j));
  __syncthreads();
  const int slot = s * nb + key_index(*s_key);
  const T old = a.gf[s];
  const T bf = ldcg(lf + slot);
  const bool take = widen(bf) > widen(old);
  if (take) {
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      a.gp[(size_t)k * s_cnt + s] = ldcg(lp + (size_t)k * lld + slot);
  }
  __syncthreads();                     // every thread has read old and bf
  if (threadIdx.x == 0 && take) {
    a.gf[s] = bf;
    if (a.counts) atomicAdd(a.counts + 3 * s + 1, 1);   // publications
  }
  if (act != kActSync) return;
  if (a.topo) {
    T* scratch = a.scratch;
    const T* slf = scratch + (size_t)d * lld;
    for (int e = threadIdx.x; e < nb * (d + 1); e += blockDim.x) {
      const int k = e / nb, j = e - k * nb;
      scratch[(size_t)k * lld + s * nb + j] =
          k < d ? ldcg(lp + (size_t)k * lld + s * nb + j)
                : ldcg(lf + s * nb + j);
    }
    __syncthreads();
    const int nbrs = a.topo == kRing ? 2 : 4;
    for (int e = threadIdx.x; e < nb * (d + 1); e += blockDim.x) {
      const int k = e / nb, j = e - k * nb;
      int w = j;
      T best = slf[s * nb + j];
      for (int q = 0; q < nbrs; ++q) {
        const int o = neighbor_id(j, nb, a.topo, a.rows, a.cols, q);
        if (widen(slf[s * nb + o]) > widen(best)) {
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
  const T g = take ? bf : old;
  for (int e = threadIdx.x; e < nb * d; e += blockDim.x) {
    const int k = e / nb, j = e - k * nb;
    lp[(size_t)k * lld + s * nb + j] = a.gp[(size_t)k * s_cnt + s];
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) lf[s * nb + j] = g;
}

// One cluster of csize CTAs a particle block (cluster b of swarm s is
// blockIdx.x / csize = s * nb + b; csize 1: no cluster), blockDim.x
// threads over the block's lanes, in chunks of blockDim.x. viol null: the
// raw fitness fold; else Deb's rule against pbv, which carries the
// violation of each pbest. The queue holds the lanes whose raw fitness
// beats the attractor's fitness (gf[s], or the async mode's lf[s*nb + b]);
// gbest is not Deb-gated, as in the reference.
//
// A chunk: every rank reads fit and pbf (viol, pbv) of the chunk's lanes,
// decides `improved` and compacts the improving lanes (vec4: the groups
// of four lanes with one improving) into s_cols with a warp ballot; a
// cluster barrier (every rank has read pbf); rank 0 writes pbf (pbv); each
// rank copies rows [d*rank/csize, d*(rank+1)/csize) of the improving
// columns (copy_columns). Rank 0 alone reads the attractor's fitness,
// builds the queue key (a warp-shuffle max, then one shared atomicMax a
// warp), counts, and writes the mode's output: aux_fit/aux_idx (queue),
// keys[s] (fused), the block's winner into lp/lf (async). Then, outside
// the queue mode, it arrives at arrive[s]; the block that counts nb - 1
// arrivals runs publish_swarm and resets arrive[s] to 0 for the next
// launch. Every block reads gf[s] or lf[blk] before it arrives and writes
// its outputs (released) before it arrives, so the publish, which overwrites
// gf and every lf and lp of the swarm, starts only after every block of
// the swarm is done with them. The last chunk's copies are issued while
// the arrival's atomic is in flight and before the publish: the publish
// reads no pbest, and the fence before the arrival waits for no copy.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
    split_fold_publish_kernel(FoldArgs<T> a) {
  __shared__ int s_cols[kFoldThreads];
  __shared__ unsigned long long s_key;
  __shared__ int s_m, s_any, s_last;
  const int csize = a.csize;
  const int rank = csize > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const bool lead = rank == 0;
  const int nb = a.n / a.bn;
  const int blk = (int)(blockIdx.x / (unsigned)csize);
  const int s = blk / nb, b = blk - s * nb;
  const size_t ld = (size_t)a.s_cnt * a.n;
  const int base = s * a.n + b * a.bn;      // the block's first column
  const int k0 = (int)((long long)a.d * rank / csize);
  const int k1 = (int)((long long)a.d * (rank + 1) / csize);
  const int t = threadIdx.x, nt = blockDim.x;
  const unsigned lane_lt = (1u << (t & 31)) - 1u;
  float g = 0.0f;
  if (lead) g = widen(a.mode == kAsync ? a.lf[blk] : a.gf[s]);
  if (t == 0) {
    s_key = 0ull;
    s_m = 0;
    s_any = 0;
  }
  __syncthreads();
  unsigned long long key = 0ull;
  int m = 0;
  for (int c0 = 0; c0 < a.bn; c0 += nt) {
    const int l = c0 + t;
    const int col = base + l;
    bool imp = false;
    float f = 0.0f, v = 0.0f;
    if (l < a.bn) {
      f = widen(a.fit[col]);
      if (a.viol) {
        v = widen(a.viol[col]);
        imp = deb_improved(f, v, widen(a.pbf[col]), widen(a.pbv[col]));
      } else {
        imp = f > widen(a.pbf[col]);
      }
      if (lead && f > g) {                  // the queue
        const unsigned long long kk = make_key(f, b * a.bn + l);
        key = kk > key ? kk : key;
      }
    }
    // the entries: (lane << 4) | mask of its improving lanes
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, imp);
    const unsigned nib = (mask >> (t & 28)) & 0xFu;
    const bool has = a.vec4 ? (t & 3) == 0 && nib : imp;
    const int ent = (l << 4) | (a.vec4 ? (int)nib : 1);
    const unsigned hm = __ballot_sync(0xFFFFFFFFu, has);
    int at = 0;
    if ((t & 31) == 0 && hm) at = atomicAdd(&s_m, __popc(hm));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (has) s_cols[at + __popc(hm & lane_lt)] = ent;
    cluster_sync(csize);   // s_cols whole; every rank has read pbf (pbv)
    m = s_m;
    if (lead && imp) {                // widened from T: exact
      a.pbf[col] = narrow<T>(f);
      if (a.viol) a.pbv[col] = narrow<T>(v);
    }
    if (lead && t == 0 && m) s_any = 1;
    if (c0 + nt < a.bn) {           // not the last chunk: its copies now
      copy_rows(a, s_cols, m, base, k0, k1, ld);
      __syncthreads();
      if (t == 0) s_m = 0;
      __syncthreads();
    }
  }
  if (!lead) {
    copy_rows(a, s_cols, m, base, k0, k1, ld);
    return;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, key, o);
    key = other > key ? other : key;
  }
  if ((t & 31) == 0 && key) atomicMax(&s_key, key);
  __syncthreads();
  key = s_key;
  if (t == 0 && a.counts) {
    if (key) {
      atomicAdd(a.counts + 3 * s, 1);                 // queue updates
      if (a.mode == kFused) atomicAdd(a.counts + 3 * s + 1, 1);  // pubs
    }
    if (s_any) atomicAdd(a.counts + 3 * s + 2, 1);    // block improvements
  }
  if (a.mode == kQueue) {
    if (t == 0) {
      const int w = key ? key_index(key) : b * a.bn;
      a.aux_fit[blk] = key ? a.fit[s * a.n + w]
                           : narrow<T>(-__int_as_float(0x7f800000));
      a.aux_idx[blk] = w;
    }
  } else {
    if (a.mode == kFused) {
      if (t == 0 && key) atomicMax(a.keys + s, key);
    } else if (key) {       // async: the block's winner into its local best
      const int wc = s * a.n + key_index(key);
      const size_t lld = (size_t)a.s_cnt * nb;
      for (int k = t; k < a.d; k += nt)
        a.lp[(size_t)k * lld + blk] = a.pos[(size_t)k * ld + wc];
      if (t == 0) a.lf[blk] = a.fit[wc];
    }
    // The arrival: the barrier orders every thread's outputs before thread
    // 0's release fence, and the last block's acquire fence orders every
    // other block's outputs before the barrier after which its threads
    // read them (the semaphore pattern of CUTLASS's Semaphore).
    __syncthreads();
    if (t == 0) {
      fence_acq_rel_gpu();
      const bool last = atomicAdd(a.arrive + s, 1) == nb - 1;
      if (last) {
        a.arrive[s] = 0;                    // every block has arrived
        fence_acq_rel_gpu();
      }
      s_last = last;
    }
  }
  copy_rows(a, s_cols, m, base, k0, k1, ld);   // beside the arrival
  if (a.mode == kQueue) return;
  __syncthreads();
  if (s_last) publish_swarm(a, s, nb, &s_key);
}

#ifdef PSO_T_BF16
typedef void (*AdvanceKernel)(Store*, Store*, const Store*, const Store*,
                              const float*, const int*, const uint32_t*,
                              const uint32_t*, int, int, int, int, int,
                              uint32_t, Coef);
// [lanes == 8][rule]
const AdvanceKernel kAdvance[2][3] = {
    {split_advance_bf16_kernel<0, 1>, split_advance_bf16_kernel<1, 1>,
     split_advance_bf16_kernel<2, 1>},
    {split_advance_bf16_kernel<0, 8>, split_advance_bf16_kernel<1, 8>,
     split_advance_bf16_kernel<2, 8>}};
typedef void (*CheckKernel)(unsigned long long*);
const CheckKernel kCheck[kOps] = {
    split_bf16_check_kernel<kOpMul>, split_bf16_check_kernel<kOpAdd>,
    split_bf16_check_kernel<kOpSub>, split_bf16_check_kernel<kOpMax>,
    split_bf16_check_kernel<kOpMin>, split_bf16_check_kernel<kOpDraw>};
#else
typedef void (*AdvanceKernel)(Store*, Store*, const Store*, const Store*,
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
#endif

}  // namespace

extern "C" {

// One advance of every element of the [D, S*N] state (iteration
// its[s] + it_off + 1 of swarm s) with rule `rule`; the attractor of
// column col is column col / gdiv of `attractor`. The arrays are of the
// library's storage type, the coefficients its values. `lanes`: 1, or in
// bfloat16 8, the 16-byte path, which needs gdiv % 8 == 0, no member
// table and pos, vel and pbp on 16 bytes (refused otherwise).
int pso_split_advance(Store* pos, Store* vel, const Store* pbp,
                      const Store* attractor, const float* bounds,
                      const int* fids, const unsigned* seeds,
                      const unsigned* its, int n, int d, int s_cnt, int gdiv,
                      unsigned it_off, int rule, float w, float c1, float c2,
                      float k0, float k1, float k2, int lanes, void* stream) {
  if (n < 1 || d < 1 || s_cnt < 1 || gdiv < 1 || n % gdiv ||
      rule < 0 || rule > 2 || (size_t)s_cnt * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const Coef cf{w, c1, c2, k0, k1, k2};
#ifdef PSO_T_BF16
  const bool v8 = lanes == 8;
  if ((lanes != 1 && !v8) ||
      (v8 && (gdiv % 8 || fids ||
              ((uintptr_t)pos | (uintptr_t)vel | (uintptr_t)pbp) % 16)))
    return (int)cudaErrorInvalidValue;
  const int ld = s_cnt * n;
  const int tiles = (ld + lanes - 1) / lanes;         // a thread each, a row
  const int threads = tiles < kAdvanceThreads ? (tiles + 31) / 32 * 32
                                              : kAdvanceThreads;
  const dim3 grid((unsigned)((tiles + threads - 1) / threads),
                  (unsigned)(d < 65535 ? d : 65535));
  kAdvance[v8][rule]<<<grid, threads, 0, (cudaStream_t)stream>>>(
      pos, vel, pbp, attractor, bounds, fids, (const uint32_t*)seeds,
      (const uint32_t*)its, n, d, s_cnt, gdiv, ld / gdiv, (uint32_t)it_off,
      cf);
#else
  if (lanes != 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)d * s_cnt * n;
  kAdvance[rule]<<<grid_for(total), kAdvanceThreads, 0,
                   (cudaStream_t)stream>>>(
      pos, vel, pbp, attractor, bounds, fids, (const uint32_t*)seeds,
      (const uint32_t*)its, n, d, s_cnt, gdiv, (uint32_t)it_off, cf);
#endif
  return (int)cudaGetLastError();
}

#ifdef PSO_T_BF16
// pso_split_bf16_check's op (0 mul, 1 add, 2 sub, 3 max, 4 min, 5 the
// draws' pair rounding) on every operand pair, into out[3] (zeroed by the
// caller, out[1] set to all ones): mismatches, the first mismatch's index,
// the pairs checked.
int pso_split_bf16_check(int op, unsigned long long* out, void* stream) {
  if (op < 0 || op >= kOps || !out) return (int)cudaErrorInvalidValue;
  kCheck[op]<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
#endif

// The pbest fold and the intra-block queue of every particle block, and
// the cross-block stage of every swarm in the same launch: mode 0 (queue:
// aux_fit/aux_idx [S*nb]; no cross-block stage, ops.queue_epilogue is the
// caller's), 1 (fused: keys[S], zero between launches, into gp/gf) or 2
// (async: lp/lf, act[S] of 0 none / 1 publish and pull / 2 publish only).
// topo 0 pulls gbest; 1 (ring) and 2 (von Neumann on a rows x cols torus
// of the nb blocks) pull the neighbourhood best, through scratch [D+1,
// S*nb]. arrive[S] (modes 1 and 2): int32 arrival counters, zero before
// the launch and zero again after it. Each particle block runs on a
// cluster of csize CTAs (1 or 2). viol and pbv null: the raw fold;
// counts null: no counting. A refused launch is returned, never retried
// another way.
int pso_split_fold_publish(const Store* pos, Store* pbp, Store* pbf,
                           Store* pbv, const Store* fit, const Store* viol,
                           Store* gp, Store* gf, Store* lp, Store* lf,
                           unsigned long long* keys, Store* aux_fit,
                           int* aux_idx, int* counts, const int* act,
                           int* arrive, Store* scratch, int n, int d, int bn,
                           int s_cnt, int mode, int topo, int rows, int cols,
                           int csize, void* stream) {
  const bool pub = mode == kFused || mode == kAsync;
  if (n < 1 || d < 1 || s_cnt < 1 || bn < 1 || n % bn || (viol && !pbv) ||
      mode < kQueue || mode > kAsync ||
      (mode == kQueue && !(aux_fit && aux_idx && gf)) ||
      (mode == kFused && !(keys && gp && gf)) ||
      (mode == kAsync && !(lp && lf && act && gp && gf)) ||
      (pub && !arrive) || topo < 0 || topo > kVonNeumann ||
      (topo && (mode != kAsync || !scratch)) ||
      (topo == kVonNeumann &&
       (rows < 1 || cols < 1 || rows * cols != n / bn)) ||
      (csize != 1 && csize != kMaxCluster) ||
      (size_t)s_cnt * n >= (1u << 31) ||
      (size_t)s_cnt * (n / bn) * csize >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  // copies four lanes at a time where every row's block starts on four
  // lanes' bytes (16 in float, 8 in bfloat16)
  const int vec4 = n % 4 == 0 && bn % 4 == 0 &&
                   ((uintptr_t)pos | (uintptr_t)pbp) % (4 * sizeof(Store)) ==
                       0;
  const FoldArgs<Store> a{pos, pbp, pbf, pbv, fit, viol, gp, gf, lp, lf,
                          keys, aux_fit, aux_idx, counts, act, arrive,
                          scratch, n, d, bn, s_cnt, mode, topo, rows, cols,
                          csize, vec4};
  const int threads = bn < kFoldThreads ? (bn + 31) / 32 * 32 : kFoldThreads;
  const unsigned blocks = (unsigned)(s_cnt * (n / bn) * csize);
  if (csize == 1) {
    split_fold_publish_kernel<Store>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, split_fold_publish_kernel<Store>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
