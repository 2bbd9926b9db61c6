// The decode kernel's instantiations for one cache type (f32 cache);
// see flash_decode.cu.
#include "flash_decode.cuh"

namespace rt_decode {
template cudaError_t dispatch_lanes<float>(int, const Args&, cudaStream_t);
}  // namespace rt_decode
