// Device code shared by the banded join's kernels (K1 fused sort + count,
// K2 tile sort, K3 global sort, K4 general count, K5 narrow count) and the
// key-value sort (K7a, K7b): the shared-memory sorting networks (keys only
// and key-value), 16-byte tile copies, the band binary
// searches, block reductions, the per-tile stats row and the narrow-band
// count with its exactness certificate.  One definition each, so the
// kernels cannot drift apart on them (the JAX package's make_tile_stats_row
// and make_contributions play the same role for its Pallas kernels).
//
// Everything sits in an unnamed namespace: each kernel source is its own
// translation unit and gets its own copy.  Block-wide helpers synchronise
// and must be called by every thread of the block.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kOvRows = 8;
constexpr int kOv = kLanes * kOvRows;
constexpr int kMaxI32 = 0x7fffffff;
constexpr int kMinI32 = -kMaxI32 - 1;
constexpr int kPackLimit = 1 << 29;
constexpr int kThreads = 512;      // block size of the count kernels
constexpr int kMaxThreads = 1024;  // block size of the sorts on 16K+ tiles
constexpr int kMaxWarps = kMaxThreads / 32;

enum Method { kBitonic = 0, kBlocks = 1, kOddEven = 2, kBitonicAlt = 3 };

__device__ __forceinline__ void compare_exchange(int* s, int i, int j) {
    const int a = s[i];
    const int b = s[j];
    s[i] = min(a, b);
    s[j] = max(a, b);
}

// Stages d = h, h/2, ..., 1 of an ascending bitonic merge over s[0, n):
// every key i with bit d clear is exchanged with key i + d.
__device__ void merge_stages(int* s, int n, int h) {
    const int pairs = n >> 1;
    for (int d = h; d >= 1; d >>= 1) {
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
            compare_exchange(s, i, i + d);
        }
        __syncthreads();
    }
}

// Sorts s[0, n) ascending in aligned segments of `seg` keys (seg a power of
// two dividing n), running levels k0..seg of the bitonic network in its
// flip form: the first stage of level k pairs each key with its mirror in
// the k-block, so every exchange is ascending.  k0 = 2 sorts each segment;
// k0 = seg merges segments whose two halves are already sorted.
__device__ void sort_segments(int* s, int n, int seg, int k0) {
    const int pairs = n >> 1;
    for (int k = k0; k <= seg; k <<= 1) {
        const int h = k >> 1;
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int r = p & (h - 1);
            const int i = ((p & ~(h - 1)) << 1) | r;
            compare_exchange(s, i, (i | (k - 1)) - r);
        }
        __syncthreads();
        merge_stages(s, n, h >> 1);
    }
}

// The key-value forms of the networks above (K7): keys are compared, and a
// key's value moves with it.  Ties are left in place, so equal keys keep
// whatever value order the network gives them (a bitonic network is not
// stable, on the TPU either).
__device__ __forceinline__ void compare_exchange_kv(int* k, int* v, int i,
                                                    int j) {
    const int a = k[i];
    const int b = k[j];
    if (b < a) {
        k[i] = b;
        k[j] = a;
        const int t = v[i];
        v[i] = v[j];
        v[j] = t;
    }
}

__device__ void merge_stages_kv(int* k, int* v, int n, int h) {
    const int pairs = n >> 1;
    for (int d = h; d >= 1; d >>= 1) {
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
            compare_exchange_kv(k, v, i, i + d);
        }
        __syncthreads();
    }
}

// Sorts k[0, n) ascending, v riding (n a power of two), in the flip form
// of sort_segments.  Ends synchronised.
__device__ void sort_kv(int* k, int* v, int n) {
    const int pairs = n >> 1;
    for (int kk = 2; kk <= n; kk <<= 1) {
        const int h = kk >> 1;
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int r = p & (h - 1);
            const int i = ((p & ~(h - 1)) << 1) | r;
            compare_exchange_kv(k, v, i, (i | (kk - 1)) - r);
        }
        __syncthreads();
        merge_stages_kv(k, v, n, h >> 1);
    }
}

__device__ void odd_even_passes(int* s, int n, int passes) {
    for (int round = 0; round < passes; ++round) {
        for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
            compare_exchange(s, 2 * p, 2 * p + 1);
        }
        __syncthreads();
        for (int p = threadIdx.x; p < n / 2 - 1; p += blockDim.x) {
            compare_exchange(s, 2 * p + 1, 2 * p + 2);
        }
        __syncthreads();
    }
}

// One tile's sort by method ("bitonic" and "bitonic_alt": full ascending
// sort; "blocks": aligned b-block sorts, then half-shifted b-block merges
// over [b/2, T - b/2), b = min(next_pow2(2*passes), T); "oddeven": `passes`
// rounds of even and odd transposition phases).  Ends synchronised.
__device__ void sort_tile(int* v, int tile, int method, int passes) {
    if (method == kBlocks) {
        int b = 1;
        while (b < 2 * passes) b <<= 1;
        b = min(b, tile);
        sort_segments(v, tile, b, 2);
        if (b < tile) sort_segments(v + b / 2, tile - b, b, b);
    } else if (method == kOddEven) {
        odd_even_passes(v, tile, passes);
    } else {
        sort_segments(v, tile, tile, 2);
    }
}

// dst[0, n) = src[0, n) with 16-byte accesses (both 16-byte aligned, n a
// multiple of 4).  No barrier.
__device__ __forceinline__ void copy_keys(int* __restrict__ dst,
                                          const int* __restrict__ src, int n) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
}

// v[i] = ~v[i]: an order-reversing bijection of int32, so an ascending
// network over ~v sorts (or merges) v descending.  Ends synchronised.
__device__ void complement_keys(int* v, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = ~v[i];
    __syncthreads();
}

// First index in a[lo, n) whose key is >= key (strict = false) or > key
// (strict = true).
__device__ __forceinline__ int bound(const int* a, int lo, int n, int key,
                                     bool strict) {
    int hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int x = a[mid];
        if (x < key || (strict && x == key)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Number of keys in the sorted run a[0, n) equal to key.
__device__ __forceinline__ int equal_count(const int* a, int n, int key) {
    const int lo = bound(a, 0, n, key, false);
    return bound(a, lo, n, key, true) - lo;
}

__device__ __forceinline__ int warp_min(int x) {
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ int warp_max(int x) {
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Block-wide reductions (blockDim.x a multiple of 32, at most kMaxThreads).
// The result is valid in thread 0.
__device__ int block_min(int x) {
    __shared__ int part[kMaxWarps];
    x = warp_min(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_min(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : kMaxI32);
    }
    __syncthreads();
    return x;
}

__device__ int block_max(int x) {
    __shared__ int part[kMaxWarps];
    x = warp_max(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_max(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : kMinI32);
    }
    __syncthreads();
    return x;
}

__device__ long long block_sum(long long x) {
    __shared__ long long part[kMaxWarps];
    x = warp_sum(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_sum(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0LL);
    }
    __syncthreads();
    return x;
}

// The stats row [min, max without MAXI32 padding, adjacent inversions] of
// the tile v[0, tile), written to row[0..2] by thread 0.  Inversions are
// counted only for the inexact sorters; the exact ones report 0, as the
// JAX kernel's stats row does.
__device__ void tile_stats_row(const int* v, int tile, bool count_inversions,
                               int* row) {
    int mn = kMaxI32, mx = kMinI32, inv = 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int x = v[i];
        mn = min(mn, x);
        if (x != kMaxI32) mx = max(mx, x);
        if (count_inversions && i + 1 < tile && x > v[i + 1]) ++inv;
    }
    mn = block_min(mn);
    mx = block_max(mx);
    inv = static_cast<int>(block_sum(inv));
    if (threadIdx.x == 0) {
        row[0] = mn;
        row[1] = mx;
        row[2] = inv;
    }
}

// Loads tile t's narrow band S[row_off*128, +tile + kOv) into band when it
// lies inside s[0, s_len); returns whether it does (nothing is read if not).
// No barrier.
__device__ bool load_band(int* band, const int* s, long long s_len,
                          int row_off, int tile) {
    const long long start = static_cast<long long>(row_off) * kLanes;
    const bool in_range = row_off >= 0 && start + tile + kOv <= s_len;
    if (in_range) copy_keys(band, s + start, tile + kOv);
    return in_range;
}

// The narrow-band count of K1 and K5 for one sorted tile v[0, tile) and its
// band[0, tile + kOv): equal-key pairs (keys < PACK_LIMIT) of every tile key
// against band[:tile] and of the tile's last kOv keys against band[tile:],
// then the certificate
//   ok = need <= T/128 || (mx_pre < ovh_min && need <= T/128 + OV_ROWS)
// (mx_pre: max of tile row T/128 - OV_ROWS - 1; ovh_min: min of band row
// T/128).  Thread 0 writes *count = ok ? pairs : 0 and *flag = 0 (ok),
// 1 (recount exactly) or 2 (band outside S: nothing was read).  The count
// is a binary search per key instead of the TPU's bitonic merge of packed
// key*4+tag runs; it equals the merge's count whenever the tile is sorted.
__device__ void narrow_count(const int* v, const int* band, int tile,
                             bool in_range, int need, long long* count,
                             int* flag) {
    const int pre_lo = tile - kOv - kLanes;
    int mx_pre = kMinI32, ovh_min = kMaxI32;
    long long cnt = 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int x = v[i];
        if (i >= pre_lo && i < pre_lo + kLanes) mx_pre = max(mx_pre, x);
        if (in_range && x < kPackLimit) {
            cnt += equal_count(band, tile, x);
            if (i >= tile - kOv) cnt += equal_count(band + tile, kOv, x);
        }
    }
    if (in_range && threadIdx.x < kLanes) ovh_min = band[tile + threadIdx.x];
    mx_pre = block_max(mx_pre);
    ovh_min = block_min(ovh_min);
    cnt = block_sum(cnt);
    if (threadIdx.x == 0) {
        const int rpt = tile / kLanes;
        const bool ok = in_range &&
            (need <= rpt || (mx_pre < ovh_min && need <= rpt + kOvRows));
        *count = ok ? cnt : 0;
        *flag = in_range ? (ok ? 0 : 1) : 2;
    }
}

// Sets a kernel's dynamic shared memory, launches it and returns the CUDA
// error code (0 on success): a refused launch never runs, and only
// cudaGetLastError reports it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, int smem, void* stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
