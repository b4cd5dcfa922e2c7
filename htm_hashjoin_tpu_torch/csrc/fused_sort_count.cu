// K1 for Hopper: fused per-tile sort + stats + narrow banded match count.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _fused_sort_count_kernel (entry fused_sort_count, pallas_call in
// _fused_sort_count_jit).  For each T-key tile t of the build side R it
//   1. sorts the tile (sort_tile in banded_common.cuh: "bitonic", "blocks"
//      or "oddeven"),
//   2. writes the sorted tile and the stats row [min, max without MAXI32
//      padding, adjacent inversions],
//   3. counts the tile against its S band S[row_off[t]*128, +T + OV) and
//      applies the narrow-band certificate (narrow_count, shared with K5).
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
// overflow certificate) is not needed.  Register-resident sorting stages,
// TMA loads and a persistent multi-tile loop are later work.

#include "banded_common.cuh"

namespace {

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
    const int t = blockIdx.x;
    const long long base = static_cast<long long>(t) * tile;

    copy_keys(v, r + base, tile);
    const bool in_range = load_band(band, s, s_len, row_off[t], tile);
    __syncthreads();
    sort_tile(v, tile, method, passes);
    copy_keys(sorted_out + base, v, tile);
    tile_stats_row(v, tile, method != kBitonic, stats + 3 * t);
    narrow_count(v, band, tile, in_range, rows_needed[t], counts + t,
                 flags + t);
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
    return launch(fused_sort_count_kernel, n_tiles, kThreads, smem, stream,
                  r, s, s_len, row_off, rows_needed, sorted_out, stats,
                  counts, flags, tile, method, passes);
}

extern "C" const char* htm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
