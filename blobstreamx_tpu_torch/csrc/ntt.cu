// Batched radix-2 NTT over Goldilocks, forward or inverse, for any power of
// two n = 2^L >= 2. Input and output are (batch, n) rows of u64 (int64
// tensors), natural order in and out; the inverse scales by n^-1.
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
// Design: the transform is bit reversal, then stages s = 0 .. L-1 (stage s
// pairs positions p and p + 2^s within blocks of 2^(s+1), twiddle
// tw[2^s + (p mod 2^s)]). The stages run in a few passes over device
// memory, each holding its tiles in shared memory; field/ntt.py:plan
// chooses them, and this file only follows the plan.
//  * Within a pass a thread takes 8 elements of one line, p = base + e 2^q
//    (e < 8), into registers and runs 3 stages there (radix 8), then
//    trades through shared memory for the next 3. The first such round
//    reads device memory and the last writes it, so a pass of k stages
//    makes ceil(k / 3) - 1 round trips through shared memory, not k.
//  * First pass (ntt_first_kernel): stages 0 .. k-1 work on chunks of 2^k
//    consecutive positions. After the bit reversal, chunk c holds
//    x[rev_k(i) 2^(L-k) + r] (i < 2^k, r = rev_(L-k)(c)), a stride-2^(L-k)
//    gather. A block takes 2^g chunks whose residues r are consecutive, so
//    for each i it reads 2^g consecutive words: whole 32-byte sectors at
//    g = 2, where one chunk alone would use 8 bytes of each sector. Each
//    chunk is written back as one contiguous run. For n <= 4096 this one
//    pass is the whole transform (g = 0, one chunk a block).
//  * Upper passes (ntt_upper_kernel): stages s0 .. s0+k-1 pair positions
//    that differ only in bits s0 .. s0+k-1 of p = top 2^(s0+k) + mid 2^s0 +
//    low. A block loads a tile of 2^k mids by 2^w consecutive lows (4096
//    words, 32 KiB; rows of 2^w >= 8 words, so whole sectors), runs its k
//    stages and writes it back in place. Twiddles come from the same
//    table; consecutive lows read consecutive entries. For n <= 2^20 the
//    plan is two passes (11 stages, then up to 9); larger n takes one more
//    upper pass per 9 stages.
//  * Shared-memory layouts (padding and an XOR swizzle, at each kernel)
//    put the 16 words a half-warp touches in every round on 16 distinct
//    banks.
//  * Values between stages and passes are lazy (any u64 equal mod p,
//    goldilocks.cuh): a butterfly's add skips the final compare and
//    select (its product stays canonical, which the subtraction needs).
//    The last pass makes them canonical as it stores and applies the
//    inverse's n^-1 scale there.
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

constexpr int kFirstThreads = 512;
constexpr int kUpperThreads = 256;
constexpr int kRadixBits = 3;  // stages a thread runs in registers at a time

__device__ __forceinline__ unsigned rev_bits(unsigned x, int bits) {
    return bits ? __brev(x) >> (32 - bits) : 0u;
}

// Stages q .. q+R-1 on the 2^R elements base + e 2^q (base with bits
// q .. q+R-1 clear) of one line, in registers: load(e), store(e, v), and
// tw(s, j) the twiddle of stage s at offset j within its half-block.
template <int R, class Load, class Store, class Tw>
__device__ __forceinline__ void radix_task(int q, int base, Load load, Store store, Tw tw) {
    uint64_t v[1 << R];
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) v[e] = load(e);
    const int j0 = base & ((1 << q) - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int h = 1 << r;
#pragma unroll
        for (int e = 0; e < (1 << R); ++e) {
            if (e & h) continue;
            const uint64_t a = v[e];
            const uint64_t b = gl::mul(v[e + h], tw(q + r, j0 + ((e & (h - 1)) << q)));
            v[e] = gl::add_lazy(a, b);
            v[e + h] = gl::sub(a, b);
        }
    }
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) store(e, v[e]);
}

// What a pass writes: lazy values between passes; after the last pass,
// canonical ones, scaled by n^-1 for the inverse.
__device__ __forceinline__ uint64_t finish(uint64_t v, int final_pass, int scale,
                                          uint64_t n_inv) {
    if (!final_pass) return v;
    return scale ? gl::mul(v, n_inv) : gl::canonical(v);
}

template <class Load, class Store, class Tw>
__device__ __forceinline__ void radix_any(int r, int q, int base, Load load, Store store, Tw tw) {
    if (r == 3) radix_task<3>(q, base, load, store, tw);
    else if (r == 2) radix_task<2>(q, base, load, store, tw);
    else radix_task<1>(q, base, load, store, tw);
}

// Bit reversal and stages 0 .. k-1 on 2^g chunks of 2^k positions a block.
// Rounds of up to 3 stages: the first reads device memory, the last writes
// it, and shared memory holds the chunks in between, word i of chunk b at
// b * (2^k + 8) + (i ^ ((i >> 3) & 7)): the pitch and the swizzle keep every
// round's accesses of a half-warp on distinct banks.
__global__ void __launch_bounds__(kFirstThreads)
ntt_first_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                 const uint64_t* __restrict__ tw, int log_n, int k, int g,
                 int final_pass, int scale, uint64_t n_inv) {
    extern __shared__ uint64_t sh[];
    const int pitch = (1 << k) + (g ? 8 : 0);
    const int log_res = log_n - k;  // chunks a row
    const long long blocks_per_row = 1LL << (log_res - g);
    const long long row = blockIdx.x / blocks_per_row;
    const unsigned r0 = (unsigned)(blockIdx.x % blocks_per_row) << g;
    const uint64_t* x = in + (row << log_n);
    uint64_t* y = out + (row << log_n);
    auto word = [&](int b, int i) { return b * pitch + (i ^ ((i >> 3) & 7)); };
    auto twf = [&](int s, int j) { return tw[(1 << s) + j]; };

    for (int q = 0; q < k; q += kRadixBits) {
        const int r = k - q < kRadixBits ? k - q : kRadixBits;
        const bool first = q == 0, last = q + r == k;
        const int log_hi = k - q - r;
        for (int task = threadIdx.x; task < (1 << (log_hi + g + q)); task += blockDim.x) {
            // a warp's tasks: the low bits of base first, then the chunk
            int lo, b, hi;
            if (first) {  // 8 bases then 4 chunks: whole sectors of every read
                const int hb = log_hi < 3 ? log_hi : 3;
                lo = 0;
                b = (task >> hb) & ((1 << g) - 1);
                hi = (task & ((1 << hb) - 1)) | ((task >> (hb + g)) << hb);
            } else {
                lo = task & ((1 << q) - 1);
                b = (task >> q) & ((1 << g) - 1);
                hi = task >> (q + g);
            }
            const int base = (hi << (q + r)) | lo;
            auto load = [&](int e) {
                const int i = base + (e << q);
                return first ? x[((long long)rev_bits(i, k) << log_res) + r0 + b] : sh[word(b, i)];
            };
            auto store = [&](int e, uint64_t v) {
                const int i = base + (e << q);
                if (last) {
                    const long long c = rev_bits(r0 + b, log_res);
                    y[(c << k) + i] = finish(v, final_pass, scale, n_inv);
                } else {
                    sh[word(b, i)] = v;
                }
            };
            radix_any(r, q, base, load, store, twf);
        }
        if (!last) __syncthreads();
    }
}

// Stages s0 .. s0+k-1 on tiles of 2^k mids by 2^w lows, in place, in
// rounds of up to 3 stages as above. Shared memory holds row `mid` at
// mid * 2^w, plus 8 words after every 8 rows when rows are 8 words, so
// that the two rows a half-warp touches sit on distinct banks.
__global__ void __launch_bounds__(kUpperThreads)
ntt_upper_kernel(uint64_t* __restrict__ data, const uint64_t* __restrict__ tw,
                 int log_n, int s0, int k, int w, int final_pass, int scale,
                 uint64_t n_inv) {
    extern __shared__ uint64_t sh[];
    const long long tiles_per_row = 1LL << (log_n - k - w);
    const long long row = blockIdx.x / tiles_per_row;
    const long long tile = blockIdx.x % tiles_per_row;
    const int log_lowblocks = s0 - w;
    const long long top = tile >> log_lowblocks;
    const long long low0 = (tile & ((1LL << log_lowblocks) - 1)) << w;
    uint64_t* y = data + (row << log_n) + (top << (s0 + k)) + low0;
    const int cols = 1 << w;
    auto word = [&](int mid, int t) { return (mid << w) + t + (w < 4 ? (mid >> 3) << 3 : 0); };

    for (int q = 0; q < k; q += kRadixBits) {
        const int r = k - q < kRadixBits ? k - q : kRadixBits;
        const bool first = q == 0, last = q + r == k;
        for (int task = threadIdx.x; task < (1 << (k - r + w)); task += blockDim.x) {
            const int t = task & (cols - 1);
            const int rest = task >> w;
            const int base = ((rest >> q) << (q + r)) | (rest & ((1 << q) - 1));
            const uint64_t* stage_tw = tw + low0 + t;
            auto twf = [&](int s, int j) {
                return stage_tw[(1LL << (s0 + s)) + ((long long)j << s0)];
            };
            auto load = [&](int e) {
                const int mid = base + (e << q);
                return first ? y[((long long)mid << s0) + t] : sh[word(mid, t)];
            };
            auto store = [&](int e, uint64_t v) {
                const int mid = base + (e << q);
                if (last) {
                    y[((long long)mid << s0) + t] = finish(v, final_pass, scale, n_inv);
                } else {
                    sh[word(mid, t)] = v;
                }
            };
            radix_any(r, q, base, load, store, twf);
        }
        if (!last) __syncthreads();
    }
}

constexpr int kInvalid = 1;  // cudaErrorInvalidValue

}  // namespace

// plan: n_passes triples (s0, k, width) from field/ntt.py:plan. Pass 0 is
// the first pass (s0 = 0, width = log2 of chunks a block); every other
// pass an upper pass (width = log2 of the tile's lows). The stages must
// cover 0 .. log_n - 1 in order.
extern "C" int bsx_ntt(const void* in, void* out, const void* tw, long long batch,
                       int log_n, const int* plan, int n_passes, int inverse,
                       unsigned long long n_inv, void* stream) {
    if (batch <= 0) return 0;
    if (n_passes < 1 || plan[0] != 0) return kInvalid;
    int next = 0;
    for (int p = 0; p < n_passes; ++p) {
        const int s0 = plan[3 * p], k = plan[3 * p + 1], w = plan[3 * p + 2];
        if (s0 != next || k < 1 || w < 0 || s0 + k > log_n) return kInvalid;
        if (p == 0 && (w > log_n - k || k + w > 13)) return kInvalid;
        if (p > 0 && (w > s0 || k + w > 12)) return kInvalid;
        next = s0 + k;
    }
    if (next != log_n) return kInvalid;

    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint64_t* x = static_cast<const uint64_t*>(in);
    uint64_t* y = static_cast<uint64_t*>(out);
    const uint64_t* t = static_cast<const uint64_t*>(tw);
    for (int p = 0; p < n_passes; ++p) {
        const int s0 = plan[3 * p], k = plan[3 * p + 1], w = plan[3 * p + 2];
        const int final_pass = p == n_passes - 1;
        const int scale = inverse && final_pass;
        cudaError_t err;
        if (p == 0) {
            const int words = 1 << (k + w);
            const size_t smem = (size_t)(w ? words + (8 << w) : words) * sizeof(uint64_t);
            if (smem > 48 * 1024) {  // above the default, only by opting in
                err = cudaFuncSetAttribute(ntt_first_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
                if (err != cudaSuccess) return (int)err;
            }
            const int tasks = words >> (k < kRadixBits ? k : kRadixBits);
            const int threads = tasks < kFirstThreads ? tasks : kFirstThreads;
            const long long blocks = batch << (log_n - k - w);
            ntt_first_kernel<<<(unsigned)blocks, threads, smem, st>>>(
                x, y, t, log_n, k, w, final_pass, scale, n_inv);
        } else {
            const int words = 1 << (k + w);
            const size_t smem = (size_t)(w < 4 ? words + (1 << k) : words) * sizeof(uint64_t);
            const int tasks = words >> (k < kRadixBits ? k : kRadixBits);
            const int threads = tasks < kUpperThreads ? tasks : kUpperThreads;
            const long long blocks = batch << (log_n - k - w);
            ntt_upper_kernel<<<(unsigned)blocks, threads, smem, st>>>(
                y, t, log_n, s0, k, w, final_pass, scale, n_inv);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
