// K1 for Hopper: fused per-tile sort + stats + narrow banded match count.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _fused_sort_count_kernel (entry fused_sort_count, pallas_call in
// _fused_sort_count_jit).  For each T-key tile t of the build side R it
//   1. sorts the tile ("bitonic": full sort; "blocks": aligned b-block sorts
//      then half-shifted b-block merges, b = min(next_pow2(2*passes), T);
//      "oddeven": `passes` rounds of even and odd transposition phases),
//   2. writes the sorted tile and the stats row [min, max without MAXI32
//      padding, adjacent inversions],
//   3. counts equal-key pairs (keys < PACK_LIMIT) of the tile against its
//      S band band = S[row_off[t]*128, +T + OV): every key against band[:T],
//      the tile's last OV keys also against band[T:],
//   4. applies the narrow-band certificate
//        ok = need <= T/128 || (mx_pre < ovh_min && need <= T/128 + OV_ROWS)
//      (mx_pre: max of sorted row T/128 - OV_ROWS - 1; ovh_min: min of band
//      row T/128), and writes count = ok ? pairs : 0 and flag = !ok.
// A tile whose band would end past s_len reads no S, counts 0 and gets
// flag 2: the caller's probe side lacks prepare_probe_side's end padding.
//
// What bounds it on an H100: the shared-memory compare-exchange stages of
// the sort (T/2 exchanges and one __syncthreads per stage; 20 stages for
// window 16 at T = 8192) and device-memory streaming of about 3 x 4 bytes
// per R key (tile in, sorted tile out, plus the glue's reads) and
// (T + 1024)/T x 4 bytes per S key.  The design keeps both streams to one
// pass: one block per tile holds the tile and its S band in dynamic shared
// memory (8 KB + 2 * 4 KB of int32 at T = 8192, about 68 KB, so three blocks
// share an SM), loads and stores them with 16-byte vector accesses, sorts
// and counts entirely in shared memory, and reduces the count in int64 in
// the block, so the TPU kernel's cross-tile int32 accumulator (and its
// overflow certificate) is not needed.  The count is a binary search per key
// in the band instead of the TPU's bitonic merge of packed key*4+tag runs:
// it needs no packing and gives the same pair count whenever the tile is
// sorted.  Register-resident sorting stages, TMA loads and a persistent
// multi-tile loop are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kOvRows = 8;
constexpr int kOv = kLanes * kOvRows;
constexpr int kMaxI32 = 0x7fffffff;
constexpr int kMinI32 = -kMaxI32 - 1;
constexpr int kPackLimit = 1 << 29;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum Method { kBitonic = 0, kBlocks = 1, kOddEven = 2 };

__device__ __forceinline__ void compare_exchange(int* s, int i, int j) {
    const int a = s[i];
    const int b = s[j];
    s[i] = min(a, b);
    s[j] = max(a, b);
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
        for (int d = h >> 1; d >= 1; d >>= 1) {
            for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
                const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
                compare_exchange(s, i, i + d);
            }
            __syncthreads();
        }
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

__global__ void __launch_bounds__(kThreads)
fused_sort_count_kernel(const int* __restrict__ r, const int* __restrict__ s,
                        long long s_len, const int* __restrict__ row_off,
                        const int* __restrict__ rows_needed,
                        int* __restrict__ sorted_out, int* __restrict__ stats,
                        long long* __restrict__ counts,
                        int* __restrict__ flags, int tile, int method,
                        int passes) {
    extern __shared__ int4 smem4[];
    int* v = reinterpret_cast<int*>(smem4);   // the tile, [tile]
    int* band = v + tile;                      // its S band, [tile + kOv]
    __shared__ int red_i[5][kWarps];
    __shared__ long long red_c[kWarps];

    const int t = blockIdx.x;
    const int band_len = tile + kOv;
    const long long band_start = static_cast<long long>(row_off[t]) * kLanes;
    const bool in_range = row_off[t] >= 0 && band_start + band_len <= s_len;

    const int4* r4 = reinterpret_cast<const int4*>(
        r + static_cast<long long>(t) * tile);
    for (int i = threadIdx.x; i < tile / 4; i += blockDim.x) smem4[i] = r4[i];
    if (in_range) {
        const int4* s4 = reinterpret_cast<const int4*>(s + band_start);
        int4* b4 = reinterpret_cast<int4*>(band);
        for (int i = threadIdx.x; i < band_len / 4; i += blockDim.x) b4[i] = s4[i];
    }
    __syncthreads();

    if (method == kBitonic) {
        sort_segments(v, tile, tile, 2);
    } else if (method == kBlocks) {
        int b = 1;
        while (b < 2 * passes) b <<= 1;
        b = min(b, tile);
        sort_segments(v, tile, b, 2);
        if (b < tile) sort_segments(v + b / 2, tile - b, b, b);
    } else {
        odd_even_passes(v, tile, passes);
    }

    int4* o4 = reinterpret_cast<int4*>(sorted_out + static_cast<long long>(t) * tile);
    for (int i = threadIdx.x; i < tile / 4; i += blockDim.x) o4[i] = smem4[i];

    const int pre_lo = tile - kOv - kLanes;   // sorted row T/128 - OV_ROWS - 1
    int mn = kMaxI32, mx = kMinI32, inv = 0, mx_pre = kMinI32, ovh_min = kMaxI32;
    long long cnt = 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int x = v[i];
        mn = min(mn, x);
        if (x != kMaxI32) mx = max(mx, x);
        if (i + 1 < tile && x > v[i + 1]) ++inv;
        if (i >= pre_lo && i < pre_lo + kLanes) mx_pre = max(mx_pre, x);
        if (in_range && x < kPackLimit) {
            cnt += equal_count(band, tile, x);
            if (i >= tile - kOv) cnt += equal_count(band + tile, kOv, x);
        }
    }
    if (in_range && threadIdx.x < kLanes) ovh_min = band[tile + threadIdx.x];

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    mn = warp_min(mn);
    mx = warp_max(mx);
    inv = warp_sum(inv);
    mx_pre = warp_max(mx_pre);
    ovh_min = warp_min(ovh_min);
    cnt = warp_sum(cnt);
    if (lane == 0) {
        red_i[0][warp] = mn;
        red_i[1][warp] = mx;
        red_i[2][warp] = inv;
        red_i[3][warp] = mx_pre;
        red_i[4][warp] = ovh_min;
        red_c[warp] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
        const bool live = lane < kWarps;
        mn = warp_min(live ? red_i[0][lane] : kMaxI32);
        mx = warp_max(live ? red_i[1][lane] : kMinI32);
        inv = warp_sum(live ? red_i[2][lane] : 0);
        mx_pre = warp_max(live ? red_i[3][lane] : kMinI32);
        ovh_min = warp_min(live ? red_i[4][lane] : kMaxI32);
        cnt = warp_sum(live ? red_c[lane] : 0LL);
        if (lane == 0) {
            stats[3 * t + 0] = mn;
            stats[3 * t + 1] = mx;
            stats[3 * t + 2] = inv;   // 0 after the exact bitonic sort
            const int rpt = tile / kLanes;
            const int need = rows_needed[t];
            const bool ok = in_range &&
                (need <= rpt || (mx_pre < ovh_min && need <= rpt + kOvRows));
            counts[t] = ok ? cnt : 0;
            flags[t] = in_range ? (ok ? 0 : 1) : 2;
        }
    }
}

}  // namespace

// Launches K1 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code of the launch (0 on success).  All pointers are device
// pointers; r, s and sorted_out must be 16-byte aligned.  tile must be a
// power of two in [2048, 16384] (shared memory holds 2*tile + 1024 ints).
extern "C" int htm_fused_sort_count(const int* r, const int* s, long long s_len,
                                    const int* row_off, const int* rows_needed,
                                    int* sorted_out, int* stats,
                                    long long* counts, int* flags, int n_tiles,
                                    int tile, int method, int passes,
                                    void* stream) {
    const int smem = (2 * tile + kOv) * static_cast<int>(sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(
        fused_sort_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_sort_count_kernel<<<n_tiles, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        r, s, s_len, row_off, rows_needed, sorted_out, stats, counts, flags,
        tile, method, passes);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* htm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
