// CUDA launcher and C entry point for the physics substep kernel.
//
// The per-env body lives in substep_body.cuh (see the note there: it
// replaces `_substep_kernel` of bez_isaacgym_tpu/ops/pallas_step.py).  One
// thread per env; the (rows, B) buffers are read and written at [row, env],
// so consecutive threads touch consecutive addresses.  Built by
// bez_isaacgym_tpu_torch/ops/_build.py and called through ctypes.

#include <cuda_runtime.h>

#include "substep_body.cuh"

#define BEZ_THREADS 128

__global__ void __launch_bounds__(BEZ_THREADS)
    bez_substep_kernel(const SubstepTables* __restrict__ tables,
                       const float* __restrict__ state_in,
                       const float* __restrict__ params_in,
                       float* __restrict__ out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // ragged tail
  bez_substep_env(*tables, state_in, params_in, out, i, B);
}

// Launches one substep over B envs on `stream`.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int bez_substep_launch(const void* tables, const float* state_in,
                                  const float* params_in, float* out, int B,
                                  void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + BEZ_THREADS - 1) / BEZ_THREADS;
  bez_substep_kernel<<<blocks, BEZ_THREADS, 0, (cudaStream_t)stream>>>(
      (const SubstepTables*)tables, state_in, params_in, out, B);
  return (int)cudaGetLastError();
}

extern "C" int bez_substep_tables_size() { return (int)sizeof(SubstepTables); }
