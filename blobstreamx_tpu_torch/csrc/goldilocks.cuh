// Goldilocks field arithmetic on native u64, shared by the NTT and Poseidon
// kernels. p = 2^64 - 2^32 + 1.
//
// The 128-bit product comes from one 64-bit multiply and __umul64hi, and is
// reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). This replaces the
// TPU's four 16x16-bit partial products per 32-bit limb
// (blobstreamx_tpu/field/goldilocks.py:mul_limbs): the card has a 64-bit
// multiplier, the TPU's vector lanes do not.
//
// Two kinds of value: canonical (< p) and lazy (any u64, equal mod p to the
// element it stands for; every canonical value is also lazy). The kernels
// carry lazy values through their inner loops and make them canonical once,
// before they write them: the `_lazy` functions skip the final compare and
// select. Every function is written with selects, not branches.
#pragma once

#include <stdint.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPSILON = 0xFFFFFFFFULL;  // 2^64 mod p

// lazy x -> canonical (x < 2^64 < 2p, so one subtraction)
__device__ __forceinline__ uint64_t canonical(uint64_t x) {
    return x >= P ? x - P : x;
}

// lazy a + b for lazy a and canonical b: a carried sum is below p - 1, so
// folding the carry back in as EPSILON cannot carry again
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    return s < a ? s + EPSILON : s;
}

// a - b for lazy a and b <= p: lazy, and canonical when a is. A borrowed
// difference is at least 2^64 - p + 1 > EPSILON, so adding p back
// (subtracting EPSILON mod 2^64) cannot borrow again.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d - EPSILON : d;
}

// lo + 2^64 hi = t + v (mod p) with t, v < 2^64, for any 128-bit value.
// 2^96 = -1: a borrow in lo - hi_hi leaves t >= 2^64 - 2^32, from which
// EPSILON (the borrowed 2^64) can be taken. 2^64 = EPSILON:
// v = hi_lo * EPSILON <= 2^64 - 2^33 + 1, so a carry out of t + v leaves a
// sum below 2^64 - 2^33 + 1, and folding it back as EPSILON cannot carry
// again.
__device__ __forceinline__ void split128(uint64_t lo, uint64_t hi, uint64_t& t,
                                         uint64_t& v) {
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & EPSILON;
    t = lo - hi_hi;
    t -= lo < hi_hi ? EPSILON : 0;
    v = (hi_lo << 32) - hi_lo;
}

// lazy lo + 2^64 hi for any 128-bit value
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
    uint64_t t, v;
    split128(lo, hi, t, v);
    const uint64_t r = t + v;
    return r < t ? r + EPSILON : r;
}

// canonical lo + 2^64 hi: the carried sum plus EPSILON is below p, and
// r >= p wraps u = r + EPSILON (= r - p mod 2^64), so one select makes it
// canonical
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    uint64_t t, v;
    split128(lo, hi, t, v);
    const uint64_t r = t + v;
    const uint64_t u = r + EPSILON;
    return (r < t) | (u < r) ? u : r;
}

// a * b for lazy a, b: lazy, or canonical
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
    return reduce128_lazy(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
