// K6 for Hopper: one pass of the multipass radix partition.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/radix_kernels.py:
// _scatter_megakernel (entry scatter_tiles / multipass_radix_partition,
// pallas_call in _scatter_tiles_jit).  The input is a relation whose
// T-key tiles are each sorted, so within tile t the keys of pass digit f
// form one run [a_elem[t,f], a_elem[t,f+1]) (the last run ends at T).  A
// ScatterPlan gives each run its destination row dest_row[t,f] (128 keys a
// row) in the output.  The output is MAXI32 everywhere except that key i
// of run f of tile t lies at dest_row[t,f]*128 + (i - a_elem[t,f]).
//
// The TPU kernel reaches that result through two workarounds for Mosaic,
// which has no per-element store: it expands each tile's runs into
// staging rows quantised to CH = 16 rows with a log-shift network, then
// copies every run in CH*128-key chunks, in tile order, so that a chunk's
// overhang (MAXI32 staging fill) is overwritten by the next tile's run of
// the same region or lands in the region's CH slack rows.  Every position
// the overhang touches therefore ends as MAXI32, the value the prefill put
// there, so the output is fully defined by the prefill and the run writes,
// and those writes never overlap.  Here each key is stored where it
// belongs: no staging, no chunks, no tile order.
//
// What bounds it on an H100: device memory.  The prefill writes 4 bytes
// per output key (the static output bound, about 3x the input at T = 8192
// and fanout 128: runs average half a row), the scatter reads and writes
// 4 bytes per input key.  The design: a grid-stride 16-byte prefill, then
// one block per sorted tile that holds the tile's F <= 128 plan entries in
// shared memory and stores each key after a binary search for its run;
// consecutive threads read consecutive keys, and the keys of one run go to
// consecutive addresses.  Offsets are int64: pass outputs pass 2^30 keys.

#include "banded_common.cuh"

namespace {

constexpr int kMaxFanout = 128;
constexpr int kScatterThreads = 256;

__global__ void __launch_bounds__(kScatterThreads)
prefill_kernel(int4* __restrict__ out, long long n4) {
    const int4 fill = make_int4(kMaxI32, kMaxI32, kMaxI32, kMaxI32);
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n4; i += stride) {
        out[i] = fill;
    }
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_tiles_kernel(const int* __restrict__ sorted,
                     const int* __restrict__ a_elem,
                     const int* __restrict__ dest_row, int* __restrict__ out,
                     long long out_len, int tile, int fanout) {
    __shared__ int a[kMaxFanout];
    __shared__ long long shift[kMaxFanout];   // dest_row*128 - a_elem
    const int t = blockIdx.x;
    const long long plan = static_cast<long long>(t) * fanout;
    for (int f = threadIdx.x; f < fanout; f += blockDim.x) {
        a[f] = a_elem[plan + f];
        shift[f] = static_cast<long long>(dest_row[plan + f]) * kLanes - a[f];
    }
    __syncthreads();
    const int* in = sorted + static_cast<long long>(t) * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        // the last run starting at or before i: empty runs share their
        // start with the next run, which wins
        int lo = 0;
        int hi = fanout;
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (a[mid] <= i) {
                lo = mid;
            } else {
                hi = mid;
            }
        }
        const long long pos = shift[lo] + i;
        if (pos >= 0 && pos < out_len) out[pos] = in[i];
    }
}

}  // namespace

// Launches K6 on `stream` and returns the CUDA error code (0 on success):
// the MAXI32 prefill of out[0, out_len), then one block per tile.  sorted
// holds n_tiles * tile keys, each tile sorted; a_elem and dest_row hold
// n_tiles * fanout ints (row-major, a_elem[t, 0] = 0, non-decreasing);
// out_len is a multiple of 4 and out is 16-byte aligned.  A key whose
// position falls outside out is dropped (a valid plan sends none there).
extern "C" int htm_scatter_tiles(const int* sorted, const int* a_elem,
                                 const int* dest_row, int* out,
                                 long long out_len, int n_tiles, int tile,
                                 int fanout, void* stream) {
    const long long n4 = out_len / 4;
    if (n4 > 0) {
        const long long want = (n4 + kScatterThreads - 1) / kScatterThreads;
        const int blocks = static_cast<int>(want < (1 << 20) ? want : 1 << 20);
        const int err = launch(prefill_kernel, blocks, kScatterThreads, 0,
                               stream, reinterpret_cast<int4*>(out), n4);
        if (err != 0) return err;
    }
    if (n_tiles == 0) return 0;
    return launch(scatter_tiles_kernel, n_tiles, kScatterThreads, 0, stream,
                  sorted, a_elem, dest_row, out, out_len, tile, fanout);
}
