// Batched radix-2 NTT over Goldilocks, forward or inverse, for any power of
// two n >= 2. Input and output are (batch, n) rows of u64 (int64 tensors),
// natural order in and out; the inverse scales by n^-1.
//
// Replaces: blobstreamx_tpu/ops/pallas/ntt.py:_kernel (launched by
// _ntt_planes, wrapped by ntt), which holds a (n, 128-polynomial) tile in
// VMEM for 16 <= n <= 4096, and the plain XLA stages of
// blobstreamx_tpu/field/ntt.py:_ntt_staged that the JAX package runs above
// 4096.
//
// What bounds it on the card: memory. A stage is n/2 modular multiplies
// and n adds on 8-byte values, far below the card's integer rate per byte
// moved, so the least time is one read and one write of the batch.
//
// Design:
//  * The bit reversal of the input is folded into the load.
//  * Stage s pairs elements within blocks of 2^(s+1), so after the bit
//    reversal the first min(log n, 12) stages work on contiguous chunks of
//    4096 elements (32 KiB). ntt_chunk_kernel keeps one chunk in shared
//    memory across those stages: for n <= 4096 that is the whole transform
//    in one read and one write. The twiddle of stage s depends only on the
//    index within its half-block, so one table serves every chunk.
//  * Each stage above 12 (n > 4096, the LDE sizes of a full trace) is one
//    pass over global memory (ntt_stage_kernel), one butterfly a thread.
//    Fusing those stages (a four-step split) is left for a later change.
//  * Butterflies are the plain radix-2 form. The TPU kernel's roll/where
//    trick, which pays a full-plane extra multiply per stage to avoid
//    sublane reshapes, has no reason to exist here.
//
// Twiddles: tw[m + j] = w_{2m}^j for m = 1, 2, 4, .., n/2 and j < m, with
// w the forward or inverse root; built once per (n, direction) by the
// Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int kLogChunk = 12;  // 4096 u64 = 32 KiB of shared memory
constexpr int kThreads = 256;

__global__ void ntt_chunk_kernel(const uint64_t* __restrict__ in,
                                 uint64_t* __restrict__ out,
                                 const uint64_t* __restrict__ tw,
                                 int log_n, int log_chunk, int scale,
                                 uint64_t n_inv) {
    extern __shared__ uint64_t sh[];
    const int chunk = 1 << log_chunk;
    const long long n = 1LL << log_n;
    const long long n_chunks = 1LL << (log_n - log_chunk);
    const long long row = blockIdx.x / n_chunks;
    const long long c = blockIdx.x % n_chunks;
    const uint64_t* x = in + row * n;

    if (log_chunk == log_n) {
        // whole row: coalesced read, bit-reversed store into shared memory
        for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
            const unsigned rev = __brev((unsigned)i) >> (32 - log_n);
            sh[rev] = x[i];
        }
    } else {
        // element i of bit-reversed chunk c sits at rev_n(c * chunk + i)
        for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
            const unsigned long long p = (unsigned long long)(c * chunk + i);
            const long long src = (long long)(__brevll(p) >> (64 - log_n));
            sh[i] = x[src];
        }
    }
    __syncthreads();

    for (int s = 0; s < log_chunk; ++s) {
        const int m = 1 << s;
        for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
            const int j = t & (m - 1);
            const int i0 = ((t >> s) << (s + 1)) | j;
            const int i1 = i0 + m;
            const uint64_t u = sh[i0];
            const uint64_t v = gl::mul(sh[i1], tw[m + j]);
            sh[i0] = gl::add(u, v);
            sh[i1] = gl::sub(u, v);
        }
        __syncthreads();
    }

    uint64_t* y = out + row * n + c * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
        y[i] = scale ? gl::mul(sh[i], n_inv) : sh[i];
    }
}

__global__ void ntt_stage_kernel(uint64_t* __restrict__ data,
                                 const uint64_t* __restrict__ tw,
                                 long long batch, int log_n, int s, int scale,
                                 uint64_t n_inv) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long half = 1LL << (log_n - 1);
    if (t >= batch * half) return;
    const long long row = t >> (log_n - 1);
    const long long k = t & (half - 1);
    const long long m = 1LL << s;
    const long long j = k & (m - 1);
    const long long i0 = ((k >> s) << (s + 1)) | j;
    uint64_t* y = data + row * (half * 2);
    const uint64_t u = y[i0];
    const uint64_t v = gl::mul(y[i0 + m], tw[m + j]);
    uint64_t a = gl::add(u, v);
    uint64_t b = gl::sub(u, v);
    if (scale) {
        a = gl::mul(a, n_inv);
        b = gl::mul(b, n_inv);
    }
    y[i0] = a;
    y[i0 + m] = b;
}

}  // namespace

extern "C" int bsx_ntt(const void* in, void* out, const void* tw,
                       long long batch, int log_n, int inverse,
                       unsigned long long n_inv, void* stream) {
    if (batch <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint64_t* x = static_cast<const uint64_t*>(in);
    uint64_t* y = static_cast<uint64_t*>(out);
    const uint64_t* t = static_cast<const uint64_t*>(tw);
    const int log_chunk = log_n < kLogChunk ? log_n : kLogChunk;
    const int chunk = 1 << log_chunk;
    const long long blocks = batch << (log_n - log_chunk);
    const int threads = chunk / 2 < kThreads ? chunk / 2 : kThreads;
    ntt_chunk_kernel<<<(unsigned)blocks, threads, chunk * sizeof(uint64_t), st>>>(
        x, y, t, log_n, log_chunk, inverse && log_chunk == log_n, n_inv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long butterflies = batch << (log_n - 1);
    const unsigned stage_blocks = (unsigned)((butterflies + kThreads - 1) / kThreads);
    for (int s = log_chunk; s < log_n; ++s) {
        ntt_stage_kernel<<<stage_blocks, kThreads, 0, st>>>(
            y, t, batch, log_n, s, inverse && s == log_n - 1, n_inv);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
