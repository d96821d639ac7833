// What the SpMV's two epilogues share: the section epilogue
// (csrc/window_ell.cu) and K2 (csrc/unpermute.cu).
//
// Programmatic dependent launch (Hopper).  An epilogue launched by
// launch_after() may be scheduled while the kernel before it on the stream
// (K1's fold) is finishing: its launch, and its reads of the plan's own
// arrays (split_ptr, split_base, split_of_tile, lam), overlap the fold's
// last CTAs.  It calls grid_dependency_wait() (griddepcontrol.wait) before
// its first read of anything the fold wrote (the output, the partial
// tiles, the table), and writes nothing before it.  The fold itself is
// launched as usual and triggers nothing early, so it completes as it did;
// a kernel launched after the epilogue without the attribute waits for the
// epilogue in stream order.  Launched after anything other than a kernel,
// or with numAttrs 0, the attribute does nothing and the wait returns at
// once.
//
// Argument blocks.  Each epilogue's entry point takes one block of 8-byte
// fields that the wrapper (kernels/window_ell.py) packs with struct.pack,
// so a launch passes one pointer through ctypes instead of converting a
// dozen arguments (about 0.14 us each on the host).  Both blocks begin
// with SplitTiles, which the wrapper packs once per section.  The wrapper
// names each struct's fields in order (ARG_BLOCKS), and
// tests/test_torch_epilogue.py holds those names to the structs here.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A section's split superblocks: superblock j's partial tiles are the
// workspace rows split_ptr[j] .. split_ptr[j+1]-1, summed into the output
// tiles from split_base[j] on; split_of_tile[t] is the j that owns tile t,
// or -1.  n_split 0: none.
struct SplitTiles {
  const int32_t* split_ptr;      // n_split + 1
  const int32_t* split_base;     // n_split
  const int32_t* split_of_tile;  // n_tiles
  int64_t n_split;
  int64_t n_tiles;               // output tiles of 128 floats
};
static_assert(sizeof(SplitTiles) == 5 * 8, "8-byte fields");

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch `kernel` on `stream` with programmatic stream serialization.
// Returns the CUDA error of the launch.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block,
                         cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace
