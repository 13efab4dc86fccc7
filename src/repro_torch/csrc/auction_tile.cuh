// Device code shared by the port's kernels: the per-block shared-memory
// limit (lane_resolve.cuh, the core of round_fused.cu and sweep_resolve.cu;
// auction_resolve.cu, segment_partials.cu, segment_resolve.cu and vi.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace auction_tile {

constexpr size_t kMaxSmem = 232448;          // per-block opt-in limit, sm_90

}  // namespace auction_tile
