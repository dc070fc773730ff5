// Width-12 Poseidon permutation over Goldilocks (4 full + 22 partial + 4
// full rounds, x^7 S-box, the repo's Cauchy MDS M[i][j] = 1/(i+j+12)), and
// the rate-8 no-padding sponge built on it.
//
// Replaces: blobstreamx_tpu/ops/pallas/poseidon.py:_kernel (launched by
// permute), which keeps 512 states in VMEM as lo/hi u32 planes and runs
// the MDS as an int8 7-bit-limb matmul (228,120)@(120,B) on the TPU's
// matrix unit before a 160-bit reduce.
//
// What bounds it on the card: operations. A permutation reads and writes
// 96 bytes but does 4792 modular multiplies (8 full rounds of 12 S-boxes
// of 4 multiplies plus 144 MDS terms, 22 partial rounds of 4 + 144), each
// several 32-bit integer multiply-adds.
//
// Design:
//  * One thread per state; the 12 lanes stay in registers through all 30
//    rounds, so device memory sees one read of the input and one write of
//    the output.
//  * Round constants (360) and the MDS (144) live in __constant__ memory:
//    every thread of a warp reads the same entry, which constant memory
//    broadcasts.
//  * The MDS is 144 native 64x64->128-bit multiply-adds. Each output row
//    accumulates its 12 products in 128 bits plus a small top word and is
//    reduced once (2^128 = -2^32 mod p). The entries are full-width, so
//    there is no small-entry shortcut, and the TPU's int8 limb matmul is
//    not carried over: the card multiplies 64-bit words directly.
//  * Partial rounds apply the S-box to lane 0 only.
//  * The sponge (hash_no_pad) is fused: a thread absorbs its row 8
//    elements at a time and writes only the 4-element digest. Inputs may be
//    row-major or column-major (strides), so a Merkle leaf hash reads the
//    (columns, rows) LDE matrix in place, coalesced across threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kDigest = 4;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;
constexpr int kRounds = 2 * kHalfFull + kPartial;
constexpr int kThreads = 128;

__constant__ uint64_t c_rc[kRounds * kWidth];
__constant__ uint64_t c_mds[kWidth * kWidth];

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
    const uint64_t x2 = gl::mul(x, x);
    const uint64_t x3 = gl::mul(x2, x);
    const uint64_t x6 = gl::mul(x3, x3);
    return gl::mul(x6, x);
}

__device__ __forceinline__ void mds(uint64_t s[kWidth]) {
    uint64_t out[kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; ++i) {
        uint64_t lo = 0, hi = 0, top = 0;
#pragma unroll
        for (int j = 0; j < kWidth; ++j) {
            const uint64_t m = c_mds[i * kWidth + j];
            const uint64_t pl = m * s[j];
            const uint64_t ph = __umul64hi(m, s[j]);
            lo += pl;
            const uint64_t h = ph + (lo < pl);  // ph <= 2^64 - 2: no overflow
            hi += h;
            top += (hi < h);
        }
        // 2^128 = -2^32 (mod p); top < 12
        out[i] = gl::sub(gl::reduce128(lo, hi), top << 32);
    }
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = out[i];
}

__device__ void permute(uint64_t s[kWidth]) {
    int r = 0;
    for (; r < kHalfFull; ++r) {
#pragma unroll
        for (int i = 0; i < kWidth; ++i) s[i] = sbox(gl::add(s[i], c_rc[r * kWidth + i]));
        mds(s);
    }
    for (; r < kHalfFull + kPartial; ++r) {
#pragma unroll
        for (int i = 0; i < kWidth; ++i) s[i] = gl::add(s[i], c_rc[r * kWidth + i]);
        s[0] = sbox(s[0]);
        mds(s);
    }
    for (; r < kRounds; ++r) {
#pragma unroll
        for (int i = 0; i < kWidth; ++i) s[i] = sbox(gl::add(s[i], c_rc[r * kWidth + i]));
        mds(s);
    }
}

// mode 0: permute 12 input lanes, write 12. mode 1: sponge-hash n_in
// elements (no padding), write the 4-element digest.
__global__ void poseidon_kernel(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out, long long batch,
                                int n_in, long long row_stride,
                                long long col_stride, int mode) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const uint64_t* src = in + b * row_stride;
    uint64_t s[kWidth];
    if (mode == 0) {
#pragma unroll
        for (int i = 0; i < kWidth; ++i) s[i] = src[i * col_stride];
        permute(s);
#pragma unroll
        for (int i = 0; i < kWidth; ++i) out[b * kWidth + i] = s[i];
        return;
    }
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = 0;
    for (int off = 0; off < n_in; off += kRate) {
        const int c = n_in - off < kRate ? n_in - off : kRate;
#pragma unroll
        for (int i = 0; i < kRate; ++i) {
            if (i < c) s[i] = src[(long long)(off + i) * col_stride];
        }
        permute(s);
    }
#pragma unroll
    for (int i = 0; i < kDigest; ++i) out[b * kDigest + i] = s[i];
}

int launch(const void* in, void* out, long long batch, int n_in,
           long long row_stride, long long col_stride, int mode, void* stream) {
    if (batch <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
    poseidon_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), batch,
        n_in, row_stride, col_stride, mode);
    return (int)cudaGetLastError();
}

}  // namespace

// rc, mds: host arrays of 360 and 144 u64, copied to the current device
extern "C" int bsx_poseidon_set_constants(const void* rc, const void* mds) {
    cudaError_t err = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(c_mds, mds, sizeof(c_mds));
}

extern "C" int bsx_poseidon_permute(const void* in, void* out, long long batch,
                                    long long row_stride, long long col_stride,
                                    void* stream) {
    return launch(in, out, batch, kWidth, row_stride, col_stride, 0, stream);
}

extern "C" int bsx_poseidon_hash_no_pad(const void* in, void* out,
                                        long long batch, int n_in,
                                        long long row_stride,
                                        long long col_stride, void* stream) {
    return launch(in, out, batch, n_in, row_stride, col_stride, 1, stream);
}
