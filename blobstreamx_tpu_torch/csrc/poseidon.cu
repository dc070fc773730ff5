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
// 96 bytes but does 2,251 modular multiplies in the form below (8 full
// rounds of 12 S-boxes of 4 multiplies and a 144-term MDS, one 11 x 11
// matrix, 22 partial rounds of 4 + 23), each several 32-bit multiply-adds.
//
// Design:
//  * One thread per state; the 12 lanes stay in registers through all 30
//    rounds, so device memory sees one read of each input element and one
//    write of each output element. Inputs may be row-major or
//    column-major (strides), so a Merkle leaf hash reads the (columns,
//    rows) LDE matrix in place, coalesced across threads; the sponge
//    absorbs 8 elements at a time and writes only the 4-element digest.
//  * Sparse partial rounds (Grassi et al., appendix B; the constants come
//    from ops/poseidon.py:sparse_constants): the partial rounds' constants
//    are pushed to one vector added before them and one scalar a round,
//    and their MDS factors into one dense 11 x 11 matrix applied once and
//    a sparse matrix a round (a row of 12 for lane 0, lane i += v_i * s0).
//    That is 4 + 23 multiplies a partial round instead of 4 + 144.
//  * Dense dot products (a full round's MDS rows, the 11 x 11 matrix, a
//    partial round's row) take the matrix entry in three 22/22/20-bit
//    limbs, pre-split on the host, and the state word in two 32-bit
//    halves: every partial product is < 2^54, so twelve of them add up in
//    one 64-bit register without carries (IMAD.WIDE.U32 accumulates). A
//    row is six such sums, combined and reduced once.
//  * Register and code budget. A full round runs its S-boxes and its MDS
//    rows in rolled loops, two at a step, each step pushing its results
//    into a queue of 12 registers (push below), so every register index
//    stays a compile-time constant without unrolling the rows. That keeps
//    the code small enough for the instruction caches, and under 90
//    registers with no spills; __launch_bounds__(128, 4) caps it at 128
//    registers, four blocks (16 warps) an SM at least.
//    With the 12 rows unrolled, ptxas needed 128 registers and spilled,
//    and the kernel ran about a third slower on an H100 (kernel_ab.py).
//  * Lanes are lazy between rounds (any u64 equal mod p, goldilocks.cuh):
//    a multiply, add or dot product skips the final compare and select,
//    and the lanes are made canonical once, as they are written. The dot
//    products take any u64 lanes, since their bound only needs 32-bit
//    halves.
//  * Constants live in __constant__ memory: every thread of a warp reads
//    the same entry, which constant memory broadcasts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kDigest = 4;
constexpr int kFull = 8;
constexpr int kPartial = 22;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // 65536 registers / (128 * 4) = 128 a thread
constexpr int kLimbs = 3;      // 22, 22 and 20 bits of a matrix entry
constexpr int kLimbBits = 22;
constexpr int kSboxStep = 2;  // S-boxes of a full round a loop step
constexpr int kRowStep = 2;   // MDS rows a loop step

__constant__ uint64_t c_full[kFull][kWidth];
__constant__ uint64_t c_first[kWidth];
__constant__ uint64_t c_scalars[kPartial];
__constant__ uint64_t c_cols[kPartial][kWidth - 1];
__constant__ uint32_t c_mds[kWidth][kWidth][kLimbs];
__constant__ uint32_t c_init[kWidth - 1][kWidth - 1][kLimbs];
__constant__ uint32_t c_rows[kPartial][kWidth][kLimbs];

__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c) {
    uint64_t lo = a * b;
    uint64_t hi = __umul64hi(a, b);  // <= 2^64 - 2: the carry fits
    lo += c;
    hi += lo < c;
    return gl::reduce128_lazy(lo, hi);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
    const uint64_t x2 = gl::mul_lazy(x, x);
    const uint64_t x3 = gl::mul_lazy(x2, x);
    const uint64_t x6 = gl::mul_lazy(x3, x3);
    return gl::mul_lazy(x6, x);
}

// (lo, hi) += (a_lo, a_hi); the sum stays below 2^128
__device__ __forceinline__ void add128(uint64_t& lo, uint64_t& hi, uint64_t a_lo,
                                       uint64_t a_hi) {
    lo += a_lo;
    hi += a_hi + (lo < a_lo);
}

// sum_j m[j] * s[j] mod p for N <= 12 terms, m in limbs
template <int N>
__device__ __forceinline__ uint64_t dot(const uint64_t* s, const uint32_t (*m)[kLimbs]) {
    uint64_t a0 = 0, a1 = 0, a2 = 0, b0 = 0, b1 = 0, b2 = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const uint32_t lo = (uint32_t)s[j];
        const uint32_t hi = (uint32_t)(s[j] >> 32);
        a0 += (uint64_t)lo * m[j][0];
        a1 += (uint64_t)lo * m[j][1];
        a2 += (uint64_t)lo * m[j][2];
        b0 += (uint64_t)hi * m[j][0];
        b1 += (uint64_t)hi * m[j][1];
        b2 += (uint64_t)hi * m[j][2];
    }
    // each sum < 12 * 2^54 < 2^58; the value
    // a0 + a1 2^22 + a2 2^44 + b0 2^32 + b1 2^54 + b2 2^76 < 12 p^2 < 2^132
    uint64_t lo = a0, hi = 0;
    add128(lo, hi, a1 << 22, a1 >> 42);
    add128(lo, hi, a2 << 44, a2 >> 20);
    add128(lo, hi, b0 << 32, b0 >> 32);
    add128(lo, hi, b1 << 54, b1 >> 10);  // < 2^113 so far
    const uint64_t h = b2 << 12;
    hi += h;
    const uint64_t top = (b2 >> 52) + (hi < h);  // < 16
    // 2^128 = -2^32 (mod p)
    return gl::sub(gl::reduce128_lazy(lo, hi), top << 32);
}

// q[0 .. 12-N) <- q[N .. 12), q[12-N .. 12) <- v: N values pushed into a
// queue of 12 registers. A rolled loop that pushes its results keeps every
// register index a compile-time constant.
template <int N>
__device__ __forceinline__ void push(uint64_t q[kWidth], const uint64_t v[N]) {
#pragma unroll
    for (int i = 0; i + N < kWidth; ++i) q[i] = q[i + N];
#pragma unroll
    for (int i = 0; i < N; ++i) q[kWidth - N + i] = v[i];
}

__device__ __forceinline__ void full_round(uint64_t s[kWidth], int r) {
#pragma unroll 1
    for (int i = 0; i < kWidth; i += kSboxStep) {
        uint64_t v[kSboxStep];
#pragma unroll
        for (int u = 0; u < kSboxStep; ++u) v[u] = sbox(gl::add_lazy(s[u], c_full[r][i + u]));
        push<kSboxStep>(s, v);
    }
    uint64_t out[kWidth];
#pragma unroll 1
    for (int i = 0; i < kWidth; i += kRowStep) {
        uint64_t v[kRowStep];
#pragma unroll
        for (int u = 0; u < kRowStep; ++u) v[u] = dot<kWidth>(s, c_mds[i + u]);
        push<kRowStep>(out, v);
    }
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = out[i];
}

__device__ __forceinline__ void partial_rounds(uint64_t s[kWidth]) {
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = gl::add_lazy(s[i], c_first[i]);
    uint64_t t[kWidth];  // lanes 1..11 of the result, in t[1..11]
#pragma unroll 1
    for (int i = 0; i < kWidth - 1; ++i) {
        const uint64_t v[1] = {dot<kWidth - 1>(s + 1, c_init[i])};
        push<1>(t, v);
    }
#pragma unroll
    for (int i = 1; i < kWidth; ++i) s[i] = t[i];
#pragma unroll 1
    for (int k = 0; k < kPartial; ++k) {
        s[0] = gl::add_lazy(sbox(s[0]), c_scalars[k]);
        const uint64_t s0 = dot<kWidth>(s, c_rows[k]);
#pragma unroll
        for (int i = 1; i < kWidth; ++i) s[i] = mul_add(c_cols[k][i - 1], s[0], s[i]);
        s[0] = s0;
    }
}

__device__ __forceinline__ void permute(uint64_t s[kWidth]) {
#pragma unroll 1
    for (int r = 0; r < kFull; ++r) {
        if (r == kFull / 2) partial_rounds(s);
        full_round(s, r);
    }
}

// Absorb n_in elements of a row, `rate` at a time (overwrite mode, no
// padding), permuting after each; write the first n_out lanes. A
// permutation is rate = n_in = n_out = 12, the sponge rate 8 and n_out 4.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
poseidon_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long batch, int n_in, long long row_stride,
                long long col_stride, int rate, int n_out) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const uint64_t* src = in + b * row_stride;
    uint64_t s[kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = 0;
    for (int off = 0; off < n_in; off += rate) {
        const int c = n_in - off < rate ? n_in - off : rate;
#pragma unroll
        for (int i = 0; i < kWidth; ++i) {
            if (i < c) s[i] = src[(long long)(off + i) * col_stride];
        }
        permute(s);
    }
#pragma unroll
    for (int i = 0; i < kWidth; ++i) {
        if (i < n_out) out[b * n_out + i] = gl::canonical(s[i]);
    }
}

int launch(const void* in, void* out, long long batch, int n_in,
           long long row_stride, long long col_stride, int rate, int n_out,
           void* stream) {
    if (batch <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
    poseidon_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), batch,
        n_in, row_stride, col_stride, rate, n_out);
    return (int)cudaGetLastError();
}

// n canonical entries -> n limb triples
void split_limbs(const uint64_t* m, uint32_t (*limbs)[kLimbs], int n) {
    for (int i = 0; i < n; ++i) {
        for (int l = 0; l < kLimbs; ++l) {
            limbs[i][l] = (uint32_t)((m[i] >> (l * kLimbBits)) & ((1u << kLimbBits) - 1));
        }
    }
}

}  // namespace

// Host arrays of canonical u64 (ops/poseidon.py:sparse_constants):
// full (8 x 12), first (12), scalars (22), cols (22 x 11), mds (12 x 12),
// init (11 x 11), rows (22 x 12); copied to the current device.
extern "C" int bsx_poseidon_set_constants(const void* full, const void* first,
                                          const void* scalars, const void* cols,
                                          const void* mds, const void* init,
                                          const void* rows) {
    static uint32_t mds_l[kWidth * kWidth][kLimbs];
    static uint32_t init_l[(kWidth - 1) * (kWidth - 1)][kLimbs];
    static uint32_t rows_l[kPartial * kWidth][kLimbs];
    split_limbs(static_cast<const uint64_t*>(mds), mds_l, kWidth * kWidth);
    split_limbs(static_cast<const uint64_t*>(init), init_l, (kWidth - 1) * (kWidth - 1));
    split_limbs(static_cast<const uint64_t*>(rows), rows_l, kPartial * kWidth);
    const struct {
        const void* symbol;
        const void* src;
        size_t bytes;
    } copies[] = {{&c_full, full, sizeof(c_full)},
                  {&c_first, first, sizeof(c_first)},
                  {&c_scalars, scalars, sizeof(c_scalars)},
                  {&c_cols, cols, sizeof(c_cols)},
                  {&c_mds, mds_l, sizeof(c_mds)},
                  {&c_init, init_l, sizeof(c_init)},
                  {&c_rows, rows_l, sizeof(c_rows)}};
    for (const auto& c : copies) {
        cudaError_t err = cudaMemcpyToSymbol(c.symbol, c.src, c.bytes);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

extern "C" int bsx_poseidon_permute(const void* in, void* out, long long batch,
                                    long long row_stride, long long col_stride,
                                    void* stream) {
    return launch(in, out, batch, kWidth, row_stride, col_stride, kWidth, kWidth, stream);
}

extern "C" int bsx_poseidon_hash_no_pad(const void* in, void* out,
                                        long long batch, int n_in,
                                        long long row_stride,
                                        long long col_stride, void* stream) {
    return launch(in, out, batch, n_in, row_stride, col_stride, kRate, kDigest, stream);
}
