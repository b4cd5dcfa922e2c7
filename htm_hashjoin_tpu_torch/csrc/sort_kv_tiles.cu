// K7a for Hopper: per-block key-value sort, phase A of the key-value global
// sort.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _sort_kv_megakernel (entry global_sort_kv_tiles, pallas_call in
// _sort_kv_tiles_jit).  For each block of B (key, value) pairs it sorts the
// keys ascending, each value moving with its key (linops.bitonic_sort_kv),
// ascending on every block, or, with `alternate`, descending on odd blocks
// (the TPU's "bitonic_alt"), so that each pair of blocks is a bitonic
// sequence for the global sort's next level (K7b).  Equal keys come out in
// the network's order, not the input's: the sort is not stable, as on the
// TPU.
//
// What bounds it on an H100: shared memory.  A pair is 8 bytes, so a block
// holds at most 16,384 pairs (128 KB of the 227 KB one block may claim; the
// TPU's 131,072-pair phase-A block does not fit), and the log2(B)(log2(B)+1)/2
// compare-exchange stages (105 at B = 16384) run there with a barrier each.
// Device memory sees 16 bytes a pair (one read, one write of key and value).
// The design is K2's: one block per B-pair block, keys and values in dynamic
// shared memory, 16-byte loads and stores, and a descending block sorted as
// the complement of its keys (~x reverses int32 order; values are not
// touched), so every stage is the same ascending exchange.

#include "banded_common.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
sort_kv_blocks(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
               int* __restrict__ keys_out, int* __restrict__ vals_out,
               int block, int alternate) {
    extern __shared__ int4 smem4[];
    int* k = reinterpret_cast<int*>(smem4);
    int* v = k + block;
    const long long base = static_cast<long long>(blockIdx.x) * block;
    const bool descending = alternate && (blockIdx.x & 1);

    copy_keys(k, keys_in + base, block);
    copy_keys(v, vals_in + base, block);
    __syncthreads();
    if (descending) complement_keys(k, block);
    sort_kv(k, v, block);
    if (descending) complement_keys(k, block);
    copy_keys(keys_out + base, k, block);
    copy_keys(vals_out + base, v, block);
}

}  // namespace

// Launches K7a on `stream` over n_blocks blocks of `block` pairs (one CUDA
// block each) and returns the CUDA error code (0 on success).  keys_in,
// vals_in, keys_out and vals_out are 16-byte aligned device pointers to
// n_blocks * block ints; the outputs may not overlap the inputs.  block is a
// power of two in [2048, 16384].
extern "C" int htm_sort_kv_tiles(const int* keys_in, const int* vals_in,
                                 int* keys_out, int* vals_out, int n_blocks,
                                 int block, int alternate, void* stream) {
    const int threads = block >= 16384 ? kMaxThreads : kThreads;
    const int smem = 2 * block * static_cast<int>(sizeof(int));
    return launch(sort_kv_blocks, n_blocks, threads, smem, stream, keys_in,
                  vals_in, keys_out, vals_out, block, alternate);
}
