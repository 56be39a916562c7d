// Cycles a step of the warp parse's primitives on the card, each timed
// with clock64() over a chain of 2048 dependent steps of one warp, for
// lz4net_tpu_torch/tools/parse_clocks.py (built by it, not part of the
// port's library).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 2048;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void primitives(int mode, long long* cycles, uint8_t* sink,
                           int seed) {
  __shared__ uint32_t words[2048];
  __shared__ uint32_t masks[8192];   // a 13-bit slot's lane mask
  const int lane = threadIdx.x;
  for (int i = lane; i < 8192; i += 32) {
    if (i < 2048) words[i] = (i * 2654435761u + seed) & 2047;
    masks[i] = 0;
  }
  __syncwarp();
  uint32_t v = lane * 2654435761u + seed;
  int dp = 0;
  const long long t0 = clock64();
  switch (mode) {
    case 0:   // a shared-memory load whose address is the last load
      for (int i = 0; i < STEPS; ++i) v = words[v & 2047];
      break;
    case 1:   // a shuffle from a lane the last one chose
      for (int i = 0; i < STEPS; ++i)
        v = __shfl_sync(FULL, v, (v + 1) & 31) + 1;
      break;
    case 2:   // a ballot
      for (int i = 0; i < STEPS; ++i) v = __ballot_sync(FULL, v & 1) + v;
      break;
    case 3:   // __match_any_sync on some 32 distinct keys (13 bits)
      for (int i = 0; i < STEPS; ++i)
        v = __match_any_sync(FULL, (v >> 5) & 8191) + v * 3;
      break;
    case 4:   // __match_any_sync on 8 keys
      for (int i = 0; i < STEPS; ++i)
        v = __match_any_sync(FULL, v & 7) + v * 3;
      break;
    case 5:   // the lanes on each slot from an atomicOr lane mask
      for (int i = 0; i < STEPS; ++i) {
        const int h = (v >> 5) & 8191;
        atomicOr(&masks[h], 1u << lane);
        __syncwarp();
        const uint32_t m = masks[h];
        __syncwarp();
        masks[h] = 0;
        v = v * 3 + 1 + m;
      }
      break;
    case 6:   // a literal run under 8 bytes, shared memory to the output
      for (int i = 0; i < STEPS; ++i) {
        if (lane < (int)(v & 7))
          sink[dp + lane] = ((const uint8_t*)words)[(dp + lane) & 8191];
        dp += v & 7;
        v = v * 3 + 1;
      }
      break;
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[mode] = t1 - t0;
  sink[(1 << 16) + lane] = (uint8_t)(v + dp);
}

}  // namespace

// cycles a step of each of the 7 primitives into cycles_per_step[7]
extern "C" int lz4t_warp_primitives(double* cycles_per_step) {
  long long* cycles = nullptr;
  uint8_t* sink = nullptr;
  cudaError_t err = cudaMalloc(&cycles, 8 * sizeof(long long));
  if (err == cudaSuccess) err = cudaMalloc(&sink, (1 << 16) + 64);
  for (int mode = 0; mode < 7 && err == cudaSuccess; ++mode) {
    for (int run = 0; run < 2; ++run)   // the second run is timed
      primitives<<<1, 32>>>(mode, cycles, sink, 1);
    long long got = 0;
    err = cudaMemcpy(&got, cycles + mode, sizeof(got),
                     cudaMemcpyDeviceToHost);
    cycles_per_step[mode] = (double)got / STEPS;
  }
  cudaFree(cycles);
  cudaFree(sink);
  return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}
