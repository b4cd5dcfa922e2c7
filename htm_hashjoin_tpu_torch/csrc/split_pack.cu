// The rotation packing around the Wisconsin partition split's key-value sort
// (K7) for Hopper: rot_pack_kernel turns each row's int32 key into the
// packed sort key t = (bucket << (bias_bits + restbits)) | (shard <<
// restbits) | rest, ordered by (partition, shard, key), and writes it into
// K7's padded key buffer; rot_unpack_kernel turns K7's sorted packed keys
// back into keys.
//
// Replaces no TPU kernel: the JAX package writes the packing as jnp
// arithmetic (htm_hashjoin_tpu/wisconsin/partitioner.py: _rot_pack,
// _rot_unpack), which XLA fuses into one pass each on the TPU.  It replaces
// the port's torch formulation of it (ops/rot_pack.py: rot_pack_ref,
// ops/rot_unpack.py: rot_unpack_ref), which stays as the plain version and
// the CPU path: in eager PyTorch every operator is a pass of its own over
// the column (a subtraction, shifts, ands and ors, the shard ids' arange,
// division and remainder, a copy onto the padding; the inverse's ands,
// shifts, ors and add), some 20 passes of 1 GiB each at 2^28 rows.  The
// packed key and the bits are the plain version's, exactly: int32
// subtraction and addition wrap, right shifts are arithmetic, and left
// shifts and ors act on the unsigned bits, as torch's int32 operators do.
//
// What bounds them on an H100: device memory.  The pack reads a row's key
// and writes its packed key (8 bytes a row), writes MAXI32 into each
// padding row, and where K7's value buffer is longer than the payload it
// copies the payload too (8 bytes more a row, 0 into the padding); the
// unpack reads a packed key and writes a key (8 bytes a row).  At 2^28 rows
// each moves 2 GiB: 0.64 ms at 3.35 TB/s.  The design reaches for that bound
// as follows: a grid of as many blocks as the SMs hold at once strides over
// the output in quads of four rows; a thread loads four keys (and four
// payload values) with one 16-byte streaming load and stores four packed
// keys with one 16-byte store.  The shard id of row i, (i / page_size) %
// nthreads, is computed from the row's index, so no column of ids is read:
// one 32-bit division a quad, since a page of four rows or more starts at
// most once inside a quad.  bias_bits 0 drops the shard term.  A quad that
// holds the last row, the padding past it and the rows past the last whole
// quad are written a row at a time.  The outputs are the wrapper's fresh
// buffers, 16-byte aligned; an input that is not 16-byte aligned (a view)
// is read a row at a time by the kernels' other instance.

#include "banded_common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // rows a 16-byte load
constexpr int kPad = 0x7fffffff;          // MAXI32: padding sorts last

// The bit-field layout of one split (wisconsin/partitioner.py:_kv_split).
struct Packing {
    int vmin;            // the hash's range minimum: v = key - vmin
    int skip;            // the bucket's lowest bit in v
    int b;               // the bucket's bits
    int restbits;        // the bits of v outside the bucket, kept below it
    int bias_bits;       // the shard id's bits; 0: no shard term
    unsigned page_size;  // rows a page; page p lies in shard p % nthreads
    unsigned nthreads;
};

__device__ __forceinline__ unsigned low_bits(int bits) {
    return (1u << bits) - 1u;
}

__device__ __forceinline__ int pack_row(int key, unsigned shard,
                                        const Packing& p) {
    const int v = static_cast<int>(static_cast<unsigned>(key) -
                                   static_cast<unsigned>(p.vmin));
    const unsigned bucket = static_cast<unsigned>(v >> p.skip) & low_bits(p.b);
    const unsigned hi = static_cast<unsigned>(v >> (p.skip + p.b)) << p.skip;
    const unsigned lo = static_cast<unsigned>(v) & low_bits(p.skip);
    unsigned t = (bucket << (p.bias_bits + p.restbits)) | hi | lo;
    if (p.bias_bits) t |= shard << p.restbits;
    return static_cast<int>(t);
}

__device__ __forceinline__ int unpack_row(int t, const Packing& p) {
    const unsigned rest = static_cast<unsigned>(t) & low_bits(p.restbits);
    const int bucket = t >> (p.bias_bits + p.restbits);
    const unsigned lo = rest & low_bits(p.skip);
    const unsigned hi = (rest >> p.skip) << (p.skip + p.b);
    return static_cast<int>(
        (hi | (static_cast<unsigned>(bucket) << p.skip) | lo) +
        static_cast<unsigned>(p.vmin));
}

__device__ __forceinline__ unsigned shard_of(unsigned row, const Packing& p) {
    return p.bias_bits ? (row / p.page_size) % p.nthreads : 0u;
}

// The shard ids of rows row..row + kVec - 1: one division where a page
// holds kVec rows or more, so at most one page starts inside the quad.
__device__ __forceinline__ void quad_shards(unsigned row, const Packing& p,
                                            unsigned (&s)[kVec]) {
    if (!p.bias_bits || p.page_size < kVec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[j] = shard_of(row + j, p);
        return;
    }
    const unsigned page = row / p.page_size;
    const unsigned s0 = page % p.nthreads;
    const unsigned s1 = s0 + 1 == p.nthreads ? 0u : s0 + 1;
    const unsigned next = (page + 1) * p.page_size;   // < 2^32: row < 2^31
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = row + j < next ? s0 : s1;
}

template <bool kAligned>
__device__ __forceinline__ void load_quad(const int* src, int (&x)[kVec]) {
    if constexpr (kAligned) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(src));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = __ldcs(src + j);
    }
}

__device__ __forceinline__ void store_quad(int* dst, long long q,
                                           const int (&x)[kVec]) {
    __stcs(reinterpret_cast<int4*>(dst) + q, make_int4(x[0], x[1], x[2], x[3]));
}

// Writes the packed keys of the n rows of `keys` into t_out[0, n_pad),
// MAXI32 past n.  With pay_out, copies `pay` into pay_out[0, n_pad), 0 past
// n.  kAligned: `keys` (and `pay`, with pay_out) are 16-byte aligned.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rot_pack_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
                long long n, long long n_pad, Packing p,
                int* __restrict__ t_out, int* __restrict__ pay_out) {
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long quads = n_pad / kVec;
    for (long long q = first; q < quads; q += stride) {
        const long long row = q * kVec;
        int t[kVec], v[kVec];
        if (row + kVec <= n) {
            int k[kVec];
            unsigned s[kVec];
            load_quad<kAligned>(keys + row, k);
            if (pay_out) load_quad<kAligned>(pay + row, v);
            quad_shards(static_cast<unsigned>(row), p, s);
#pragma unroll
            for (int j = 0; j < kVec; ++j) t[j] = pack_row(k[j], s[j], p);
        } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                const long long r = row + j;
                const bool in = r < n;
                t[j] = in ? pack_row(keys[r], shard_of(r, p), p) : kPad;
                v[j] = in && pay_out ? pay[r] : 0;
            }
        }
        store_quad(t_out, q, t);
        if (pay_out) store_quad(pay_out, q, v);
    }
    // the n_pad % kVec rows past the last quad, one a thread of the first
    // block
    const long long r = quads * kVec + first;
    if (r < n_pad) {
        const bool in = r < n;
        t_out[r] = in ? pack_row(keys[r], shard_of(r, p), p) : kPad;
        if (pay_out) pay_out[r] = in ? pay[r] : 0;
    }
}

// Writes the keys of the n packed keys `t` into keys_out.  kAligned: `t` is
// 16-byte aligned.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rot_unpack_kernel(const int* __restrict__ t, long long n, Packing p,
                  int* __restrict__ keys_out) {
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long quads = n / kVec;
    for (long long q = first; q < quads; q += stride) {
        int x[kVec];
        load_quad<kAligned>(t + q * kVec, x);
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = unpack_row(x[j], p);
        store_quad(keys_out, q, x);
    }
    const long long r = quads * kVec + first;
    if (r < n) keys_out[r] = unpack_row(t[r], p);
}

bool aligned(const void* x) {
    return reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

// Every shift stays below 32 bits, as the plain version's int32 operators
// need.
bool valid(const Packing& p) {
    return p.skip >= 0 && p.b >= 0 && p.restbits >= 0 && p.bias_bits >= 0 &&
           p.skip + p.b <= 31 && p.bias_bits + p.restbits <= 31;
}

// As many blocks as the SMs hold at once, or fewer where the quads need
// fewer.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long quads, int* blocks) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    const long long want = (quads + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    *blocks = static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
    return cudaSuccess;
}

}  // namespace

// Packs on `stream` the n keys of `keys` into t_out (n_pad int32, MAXI32
// past n) and, where pay_out is not null, copies the n values of `pay` into
// pay_out (n_pad int32, 0 past n).  Row i's shard id is (i / page_size) %
// nthreads.  Returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for sizes or bit widths out of range or an output
// that is not 16-byte aligned).  n <= n_pad <= 2^31.
extern "C" int htm_rot_pack(const int* keys, const int* pay, long long n,
                            long long n_pad, int vmin, int skip, int b,
                            int restbits, int bias_bits, long long page_size,
                            long long nthreads, int* t_out, int* pay_out,
                            void* stream) {
    const Packing p{vmin, skip, b, restbits, bias_bits,
                    static_cast<unsigned>(page_size),
                    static_cast<unsigned>(nthreads)};
    if (n < 0 || n_pad < n || n_pad > (1LL << 31) || !valid(p) ||
        page_size < 1 || page_size >= (1LL << 31) || nthreads < 1 ||
        nthreads >= (1LL << 31) || !aligned(t_out) ||
        (pay_out && (!pay || !aligned(pay_out)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n_pad == 0) return static_cast<int>(cudaSuccess);
    const bool vec = aligned(keys) && (!pay_out || aligned(pay));
    const auto kernel = vec ? &rot_pack_kernel<true> : &rot_pack_kernel<false>;
    int blocks = 0;
    const cudaError_t err = grid_for(kernel, n_pad / kVec, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch(kernel, blocks, kThreads, 0, stream, keys, pay, n, n_pad, p,
                  t_out, pay_out);
}

// Unpacks on `stream` the n packed keys of `t` into keys_out (n int32), and
// returns the CUDA error code (0 on success; cudaErrorInvalidValue for bit
// widths out of range or an output that is not 16-byte aligned).
extern "C" int htm_rot_unpack(const int* t, long long n, int vmin, int skip,
                              int b, int restbits, int bias_bits,
                              int* keys_out, void* stream) {
    const Packing p{vmin, skip, b, restbits, bias_bits, 1u, 1u};
    if (n < 0 || !valid(p) || !aligned(keys_out)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n == 0) return static_cast<int>(cudaSuccess);
    const auto kernel = aligned(t) ? &rot_unpack_kernel<true>
                                   : &rot_unpack_kernel<false>;
    int blocks = 0;
    const cudaError_t err = grid_for(kernel, n / kVec, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch(kernel, blocks, kThreads, 0, stream, t, n, p, keys_out);
}
