// FIPS 180-4 SHA-256 of B messages of one length L: padding, big-endian
// word packing and every compression from H0, one message per thread.
// Input (B, L) bytes, output (B, 32) digest bytes, both row-major.
//
// Replaces: blobstreamx_tpu/ops/pallas/sha256.py:_kernel (launched by
// _compress, wrapped by _hash_padded and sha256_fixed_len), which keeps
// 1024 messages a grid step in VMEM as (8, 128) u32 sublane planes, the
// padding and word packing done by XLA before it.
//
// What bounds it on the card: neither by much at the sizes it is called
// with. It must move B * (L + 32) bytes, and it does B * n_blocks * (64
// rounds + 48 schedule words) of 32-bit ALU work, a few dozen operations
// each. At B = 2^15, L = 64 both bounds are a few microseconds, so a launch
// costs more than the work; at B = 2^20 the operation bound is the larger.
//
// Design:
//  * One thread per message. The eight state words and a rolling 16-word
//    message schedule stay in registers through all 64 rounds of every
//    block, fully unrolled.
//  * Padding is done in the kernel, so the wrapper moves B * L bytes in and
//    B * 32 out and allocates nothing else. For each 64-byte block, the 128
//    threads of a CTA first copy that block of their 128 messages into
//    shared memory together (consecutive threads read consecutive bytes),
//    writing the 0x80 byte, the zero fill and the bit length where the
//    block holds them. Rows are 68 bytes apart, so the word reads that
//    follow touch 32 different banks.
//  * Each thread then reads its 16 words from its row and byte-swaps them
//    to big endian (__byte_perm).
//  * The 32-byte digest is written as two 16-byte stores.
//  * The TPU kernel's (8, 128) planes exist for its vector unit and have no
//    counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowBytes = 68;  // 64 + 4: row r starts at bank r mod 32

__constant__ uint32_t c_k[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

// One compression: state += rounds(state, w), w the block's 16 words
// (overwritten by the rolling schedule).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
        }
        const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = h + S1 + ch + c_k[t] + wt;
        const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        const uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ msgs, uint8_t* __restrict__ out,
              long long batch, long long len, int n_blocks) {
    __shared__ __align__(16) uint8_t rows[kThreads * kRowBytes];
    const long long first = (long long)blockIdx.x * kThreads;
    const long long me = first + threadIdx.x;
    const long long padded = 64LL * n_blocks;
    const unsigned long long bits = 8ULL * (unsigned long long)len;

    uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                      0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    for (int blk = 0; blk < n_blocks; ++blk) {
        // stage block blk of the CTA's messages, padding included
        for (int i = threadIdx.x; i < kThreads * 64; i += kThreads) {
            const int r = i >> 6, off = i & 63;
            const long long msg = first + r;
            const long long p = 64LL * blk + off;
            uint8_t v = 0;
            if (msg < batch) {
                if (p < len) {
                    v = msgs[msg * len + p];
                } else if (p == len) {
                    v = 0x80;
                } else if (p >= padded - 8) {
                    v = (uint8_t)(bits >> (8 * (padded - 1 - p)));
                }
            }
            rows[r * kRowBytes + off] = v;
        }
        __syncthreads();
        uint32_t w[16];
        const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + threadIdx.x * kRowBytes);
#pragma unroll
        for (int t = 0; t < 16; ++t) w[t] = __byte_perm(row[t], 0, 0x0123);
        __syncthreads();
        compress(st, w);
    }
    if (me < batch) {
        uint32_t be[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) be[i] = __byte_perm(st[i], 0, 0x0123);
        uint4* dst = reinterpret_cast<uint4*>(out + me * 32);
        dst[0] = make_uint4(be[0], be[1], be[2], be[3]);
        dst[1] = make_uint4(be[4], be[5], be[6], be[7]);
    }
}

}  // namespace

// msgs: (batch, len) bytes; out: (batch, 32) bytes, 16-byte aligned.
extern "C" int bsx_sha256_fixed_len(const void* msgs, void* out, long long batch,
                                    long long len, void* stream) {
    if (batch <= 0) return 0;
    const int n_blocks = (int)((len + 8) / 64 + 1);
    const unsigned grid = (unsigned)((batch + kThreads - 1) / kThreads);
    sha256_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(msgs), static_cast<uint8_t*>(out), batch, len,
        n_blocks);
    return (int)cudaGetLastError();
}
