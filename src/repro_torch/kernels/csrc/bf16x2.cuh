// Two bfloat16 lanes a 32-bit register and sm_90's packed instructions on
// them, shared by the bfloat16 libraries of pso_split.cu (the split advance,
// split_advance_bf16_kernel) and pso_step.cu (the fused and async kernels'
// pair path): the rule on lane pairs (advance2) and the counter hash's draws
// as lane pairs (draw24, draw_pair). Included inside each source's
// anonymous namespace, under PSO_T_BF16, after that source's mix32 (the
// counter hash's finalizer, repro/core/rng.py). pso_split.cu's
// pso_split_bf16_check holds every packed instruction here to the float
// operation rounded once on all 2^32 operand pairs
// (kernels/pso_split.py check_bf16_ops).
#pragma once

// Two bfloat16 lanes in a 32-bit register, the lower lane in the low half,
// and the packed instructions on them. Each rounds the exact result once to
// nearest even, which is what __f*_rn followed by __float2bfloat16_rn
// computes on values of bfloat16: a product of two 8-bit
// significands is exact in float, and rounding a float sum (24 bits) again
// to 8 bits gives the once-rounded sum (24 >= 2 * 8 + 2). The explicit .rn
// keeps ptxas from contracting a product and a sum into an fma, which would
// skip the product's rounding; max and min return one of their operands,
// as fmaxf and fminf do.
typedef uint32_t bf2;
__device__ __forceinline__ bf2 bmul(bf2 a, bf2 b) {
  bf2 r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ bf2 badd(bf2 a, bf2 b) {
  bf2 r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ bf2 bsub(bf2 a, bf2 b) {
  bf2 r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ bf2 bmax(bf2 a, bf2 b) {
  bf2 r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ bf2 bmin(bf2 a, bf2 b) {
  bf2 r;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// Two floats rounded to bfloat16 (to nearest even) in one instruction.
__device__ __forceinline__ bf2 bpack(float lo, float hi) {
  bf2 r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// A float that holds a value of bfloat16 (a bound, a coefficient), in both
// lanes: its high 16 bits, exactly.
__device__ __forceinline__ bf2 bboth(float f) {
  return __byte_perm(__float_as_uint(f), 0u, 0x3232);
}
__device__ __forceinline__ bf2 bboth(unsigned short h) {
  return (bf2)h * 0x10001u;
}
__device__ __forceinline__ float blo(bf2 p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bhi(bf2 p) {
  return __uint_as_float(p & 0xFFFF0000u);
}
// The lanes whose f is below t, as a mask of their halves.
__device__ __forceinline__ uint32_t below(bf2 r, float t) {
  return (blo(r) < t ? 0x0000FFFFu : 0u) | (bhi(r) < t ? 0xFFFF0000u : 0u);
}

constexpr bf2 kScale2 = 0x33803380u;   // 2^-24 in both lanes

// uniform01's draw in bfloat16 for two elements (their (h >> 8) values u0,
// u1) as a lane pair: each rounded to bfloat16 (to nearest even), then
// scaled exactly, as the reference's (h >> 8).astype(dtype) * 2**-24.
__device__ __forceinline__ bf2 draw_pair(uint32_t u0, uint32_t u1) {
  return bmul(bpack((float)u0, (float)u1), kScale2);
}
// (h >> 8) of uniform01's hash for one element, its terms summed ahead:
// hs = seed*C + it*C + stream*C + idx*C, t = idx*C + it*C.
__device__ __forceinline__ uint32_t draw24(uint32_t hs, uint32_t t) {
  return mix32(mix32(hs) ^ t) >> 8;
}

struct Coef2 { bf2 w, c1, c2; float k0, k1, k2; };
struct Row2 { bf2 lo, hi, mv, nmv, span; };

// advance<R> on a lane pair in bfloat16: the same operations in the same
// order, each one packed instruction that rounds its result once.
template <int R>
__device__ __forceinline__ void advance2(const Coef2& p, bf2 r1, bf2 r2,
                                         bf2& x, bf2& v, bf2 pb, bf2 g,
                                         const Row2& b) {
  if (R == 0) {          // pso
    const bf2 a = bmul(p.w, v);
    const bf2 c = bmul(bmul(p.c1, r1), bsub(pb, x));
    const bf2 e = bmul(bmul(p.c2, r2), bsub(g, x));
    v = bmin(bmax(badd(badd(a, c), e), b.nmv), b.mv);
    x = bmin(bmax(badd(x, v), b.lo), b.hi);
  } else if (R == 1) {   // sso: each lane picks by its own r1
    const bf2 fresh = badd(b.lo, bmul(b.span, r2));
    const float f0 = blo(r1), f1 = bhi(r1);
    const bf2 s0 =
        f0 < p.k0 ? g : (f0 < p.k1 ? pb : (f0 < p.k2 ? x : fresh));
    const bf2 s1 =
        f1 < p.k0 ? g : (f1 < p.k1 ? pb : (f1 < p.k2 ? x : fresh));
    x = bmin(bmax((s0 & 0x0000FFFFu) | (s1 & 0xFFFF0000u), b.lo), b.hi);
  } else {               // lowcost: +0 where a term is not selected
    const bf2 a = bsub(pb, x) & below(r1, 0.5f);
    const bf2 c = bsub(g, x) & below(r2, 0.5f);
    v = bmin(bmax(badd(badd(v, a), c), b.nmv), b.mv);
    x = bmin(bmax(badd(x, v), b.lo), b.hi);
  }
}
