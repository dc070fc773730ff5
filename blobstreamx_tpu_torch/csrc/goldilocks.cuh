// Goldilocks field arithmetic on native u64, shared by the NTT and Poseidon
// kernels. p = 2^64 - 2^32 + 1; every function returns a canonical value
// (< p) for canonical inputs.
//
// The 128-bit product comes from one 64-bit multiply and __umul64hi, and is
// reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). This replaces the
// TPU's four 16x16-bit partial products per 32-bit limb
// (blobstreamx_tpu/field/goldilocks.py:mul_limbs): the card has a 64-bit
// multiplier, the TPU's vector lanes do not.
#pragma once

#include <stdint.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPSILON = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    // a carry out of 2^64 is worth EPSILON; the wrapped sum is then below
    // p - 2^32, so one fold is enough
    if (s < a) return s + EPSILON;
    return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    return a < b ? d + P : d;  // wraps to a - b + p
}

// lo + 2^64 hi mod p
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & EPSILON;
    uint64_t t = lo - hi_hi;  // 2^96 = -1
    if (lo < hi_hi) t -= EPSILON;
    const uint64_t v = hi_lo * EPSILON;  // 2^64 = EPSILON, < 2^64
    uint64_t r = t + v;
    if (r < t) return r + EPSILON;  // the carried sum is then < p
    return r >= P ? r - P : r;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
