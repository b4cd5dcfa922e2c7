// K7b for Hopper: the cross-block levels of the key-value bitonic global
// sort.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _gsort_kv_pass_kernel (entry global_sort_kv_tiles, pallas_call in
// _gsort_kv_pass_jit).  The caller first sorts blocks of B pairs with K7a
// (block b ascending iff b is even: phase A).  This launcher then runs
// levels k = 2B, 4B, ..., n in place over the n pairs (n a power-of-two
// multiple of B).  A level's cross-block stages j = k/2, ..., B go in passes
// of up to `group_bits` consecutive stages, from the top, as the TPU groups
// them (GSORT_KV_BITS, which is 3 at join_kernels.py:489): each thread loads
// the 2^g pairs i + m * j_min (m < 2^g) of four neighbouring groups as
// 16-byte accesses, runs the g stages in registers in the direction of bit
// k of i, and stores them back.  A last shared-memory launch per level runs
// its stages B/2, ..., 1 inside each block (the TPU pass's include_local).
// The last level is ascending everywhere.  Values move with their keys;
// descending blocks are merged as the complement of their keys.
//
// Pass count: at n = 2^28 and B = 2^14, levels 2^15 .. 2^28 hold 105
// cross-block stages, which run in 40 passes of at most 3 stages, plus 14
// block merges: 54 launches after K7a.
//
// What bounds it on an H100: device-memory traffic.  Each pass reads and
// writes every key and value once (4 GB at 2^28 pairs, about 1.3 ms at
// 3.35 TB/s), so grouping stages is what cuts the time; a block merge reads
// and writes them once too.  Folding the last cross pass into the block
// merge, and a radix sort, are later work.

#include "banded_common.cuh"

namespace {

constexpr int kCrossThreads = 256;

__device__ __forceinline__ void exchange_kv(int& ka, int& va, int& kb, int& vb,
                                            bool ascending) {
    if (ascending ? kb < ka : ka < kb) {
        int t = ka;
        ka = kb;
        kb = t;
        t = va;
        va = vb;
        vb = t;
    }
}

__device__ __forceinline__ void exchange_kv4(int4& ka, int4& va, int4& kb,
                                             int4& vb, bool ascending) {
    exchange_kv(ka.x, va.x, kb.x, vb.x, ascending);
    exchange_kv(ka.y, va.y, kb.y, vb.y, ascending);
    exchange_kv(ka.z, va.z, kb.z, vb.z, ascending);
    exchange_kv(ka.w, va.w, kb.w, vb.w, ascending);
}

// Stages j_min << (G-1), ..., j_min of level k over pairs [0, n): each group
// is the 2^G pairs i + m * j_min, with i's bits j_min .. j_min << (G-1)
// clear; ascending iff bit k of i is clear.  j_min >= 4.
template <int G>
__global__ void __launch_bounds__(kCrossThreads)
gsort_kv_cross(int* __restrict__ keys, int* __restrict__ vals, long long n,
               long long k, long long j_min) {
    constexpr int M = 1 << G;
    const long long quads = n / (4 * M);
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         p < quads; p += stride) {
        const long long q = p * 4;
        const long long i = ((q & ~(j_min - 1)) << G) | (q & (j_min - 1));
        int4 kk[M];
        int4 vv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
            kk[m] = *reinterpret_cast<const int4*>(keys + i + m * j_min);
            vv[m] = *reinterpret_cast<const int4*>(vals + i + m * j_min);
        }
        const bool ascending = (i & k) == 0;
#pragma unroll
        for (int t = G - 1; t >= 0; --t) {
#pragma unroll
            for (int m = 0; m < M; ++m) {
                if (!(m & (1 << t))) {
                    exchange_kv4(kk[m], vv[m], kk[m | (1 << t)],
                                 vv[m | (1 << t)], ascending);
                }
            }
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
            *reinterpret_cast<int4*>(keys + i + m * j_min) = kk[m];
            *reinterpret_cast<int4*>(vals + i + m * j_min) = vv[m];
        }
    }
}

// Stages B/2, ..., 1 of level k inside each B-pair block, in shared memory.
__global__ void __launch_bounds__(kMaxThreads)
gsort_kv_block_merge(int* __restrict__ keys, int* __restrict__ vals, int block,
                     long long k) {
    extern __shared__ int4 smem4[];
    int* sk = reinterpret_cast<int*>(smem4);
    int* sv = sk + block;
    const long long base = static_cast<long long>(blockIdx.x) * block;
    const bool descending = (base & k) != 0;

    copy_keys(sk, keys + base, block);
    copy_keys(sv, vals + base, block);
    __syncthreads();
    if (descending) complement_keys(sk, block);
    merge_stages_kv(sk, sv, block, block / 2);
    if (descending) complement_keys(sk, block);
    copy_keys(keys + base, sk, block);
    copy_keys(vals + base, sv, block);
}

int log2_of(long long x) {
    int r = 0;
    while (x > 1) {
        x >>= 1;
        ++r;
    }
    return r;
}

template <int G>
cudaError_t cross_pass(int* keys, int* vals, long long n, long long k,
                       long long j_min, cudaStream_t st) {
    const long long blocks = (n / (4 << G) + kCrossThreads - 1) / kCrossThreads;
    const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : 1 << 20);
    gsort_kv_cross<G><<<grid, kCrossThreads, 0, st>>>(keys, vals, n, k, j_min);
    return cudaGetLastError();
}

}  // namespace

// Runs levels 2*block .. n of the key-value bitonic network in place on
// (keys, vals) (n pairs each, 16-byte aligned device memory) on `stream`,
// after K7a sorted their block-pair blocks with `alternate` set.  n and
// block are powers of two, 2048 <= block <= 16384, block < n; group_bits in
// [1, 3] is the number of cross-block stages a pass may hold.  Returns the
// first CUDA error code (0 on success).
extern "C" int htm_global_sort_kv_levels(int* keys, int* vals, long long n,
                                         int block, int group_bits,
                                         void* stream) {
    const int threads = block >= 16384 ? kMaxThreads : kThreads;
    const int smem = 2 * block * static_cast<int>(sizeof(int));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (group_bits < 1 || group_bits > 3) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaFuncSetAttribute(
        gsort_kv_block_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int block_bits = log2_of(block);
    for (long long k = 2LL * block; k <= n; k <<= 1) {
        for (long long j = k >> 1; j >= block;) {
            const int left = log2_of(j) - block_bits + 1;
            const int g = left < group_bits ? left : group_bits;
            const long long j_min = j >> (g - 1);
            if (g == 3) {
                err = cross_pass<3>(keys, vals, n, k, j_min, st);
            } else if (g == 2) {
                err = cross_pass<2>(keys, vals, n, k, j_min, st);
            } else {
                err = cross_pass<1>(keys, vals, n, k, j_min, st);
            }
            if (err != cudaSuccess) return static_cast<int>(err);
            j = j_min >> 1;
        }
        gsort_kv_block_merge<<<static_cast<int>(n / block), threads, smem,
                               st>>>(keys, vals, block, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
