// K3 for Hopper: the cross-block levels of a bitonic global sort.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _gsort_pass_kernel (entry global_sort_tiles, pallas_call in
// _gsort_pass_jit).  The caller first sorts blocks of B keys with K2's
// "bitonic_alt" (block b ascending iff b is even: phase A, levels 2..B of
// the network).  This launcher then runs levels k = 2B, 4B, ..., n in place
// over the n keys (n a power-of-two multiple of B): for each level, one
// launch per cross-block stage j = k/2, ..., B, where every thread
// compare-exchanges keys i and i + j in device memory in the direction of
// bit k of i (four neighbouring pairs per thread, as 16-byte accesses),
// then one shared-memory launch that runs the level's stages B/2, ..., 1
// inside each block.  The last level is ascending everywhere.
//
// What bounds it on an H100: device-memory traffic.  Each cross-block stage
// and each block launch reads and writes all n keys once: at n = 2^27 and
// B = 32768 that is 78 + 12 passes of 1 GB, about 0.3 ms each at
// 3.35 TB/s.  The design keeps each stage a pure streaming pass (coalesced
// 16-byte loads and stores, no shared memory) and folds every stage below B
// into one block launch per level.  Grouping several cross-block stages per
// pass (as the TPU kernel's GSORT_BITS groups do) and a radix sort are
// later work.

#include "banded_common.cuh"

namespace {

__device__ __forceinline__ void exchange(int& a, int& b, bool ascending) {
    const int lo = min(a, b);
    const int hi = max(a, b);
    a = ascending ? lo : hi;
    b = ascending ? hi : lo;
}

// Stage j (j >= 4) of level k over keys[0, n): pair i (bit j clear) with
// i + j, ascending iff bit k of i is clear.
__global__ void __launch_bounds__(256)
gsort_cross_stage(int* __restrict__ keys, long long n, long long k,
                  long long j) {
    const long long quads = n / 8;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         p < quads; p += stride) {
        const long long q = p * 4;
        const long long i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        int4* a4 = reinterpret_cast<int4*>(keys + i);
        int4* b4 = reinterpret_cast<int4*>(keys + i + j);
        int4 a = *a4;
        int4 b = *b4;
        const bool ascending = (i & k) == 0;
        exchange(a.x, b.x, ascending);
        exchange(a.y, b.y, ascending);
        exchange(a.z, b.z, ascending);
        exchange(a.w, b.w, ascending);
        *a4 = a;
        *b4 = b;
    }
}

// Stages B/2, ..., 1 of level k inside each B-key block, in shared memory;
// a descending block is merged as its complement.
__global__ void __launch_bounds__(kMaxThreads)
gsort_block_merge(int* __restrict__ keys, int block, long long k) {
    extern __shared__ int4 smem4[];
    int* v = reinterpret_cast<int*>(smem4);
    const long long base = static_cast<long long>(blockIdx.x) * block;
    const bool descending = (base & k) != 0;

    copy_keys(v, keys + base, block);
    __syncthreads();
    if (descending) complement_keys(v, block);
    merge_stages(v, block, block / 2);
    if (descending) complement_keys(v, block);
    copy_keys(keys + base, v, block);
}

}  // namespace

// Runs levels 2*block .. n of the bitonic network in place on `keys` (n
// keys, 16-byte aligned device memory) on `stream`, after K2 "bitonic_alt"
// sorted its block-key blocks.  n and block are powers of two, 2048 <=
// block <= 32768, block < n.  Returns the first CUDA error code (0 on
// success).
extern "C" int htm_global_sort_levels(int* keys, long long n, int block,
                                      void* stream) {
    const int threads = block >= 16384 ? kMaxThreads : kThreads;
    const int smem = block * static_cast<int>(sizeof(int));
    const long long blocks = (n / 8 + 255) / 256;
    const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : 1 << 20);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        gsort_block_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (long long k = 2LL * block; k <= n; k <<= 1) {
        for (long long j = k >> 1; j >= block; j >>= 1) {
            gsort_cross_stage<<<grid, 256, 0, st>>>(keys, n, k, j);
            err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        gsort_block_merge<<<static_cast<int>(n / block), threads, smem, st>>>(
            keys, block, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
