// Poseidon-Goldilocks round constants in a runtime table: the 360 round
// constants in __constant__ memory, filled by set_constants.
//
// poseidon_gl_mma.cu (mode "mxu24") includes this header and reads round r's
// constants at a runtime index; its library holds its own copy of the
// table, filled by poseidon_gl_mma_set_constants. The poseidon_gl library
// (modes "mxu96", "2d", "mxu", "blocked", "1d" and the fused commit)
// compiles the reference MDS in (poseidon_common.cuh) and runs the lazy
// body of poseidon_lazy.cuh instead.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_common.cuh"

namespace pos {

__constant__ uint64_t RC[N_ROUNDS * WIDTH];  // round r, lane j at r*12 + j

// Copy the 360 round constants into this library's table. Returns a
// cudaError_t code.
inline int set_constants(const uint64_t* rc) {
  return static_cast<int>(cudaMemcpyToSymbol(RC, rc, sizeof(RC)));
}

}  // namespace pos
