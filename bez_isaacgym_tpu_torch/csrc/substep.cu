// CUDA launcher and C entry points for the physics substep kernel.
//
// The per-env schedule lives in substep_body.cuh (see the note there: it
// replaces `_substep_kernel` of bez_isaacgym_tpu/ops/pallas_step.py:126).
// One warp per env, BEZ_ENVS_PER_BLOCK envs per block, each env's state in
// a tile of dynamic shared memory.  The block stages its envs' input rows
// into the tiles (consecutive threads on consecutive envs of a row), runs
// one warp per env, and writes the output rows back the same way.  The
// tables are read through the read-only path (L1).  Built by
// bez_isaacgym_tpu_torch/ops/_build.py and called through ctypes.

#include <cuda_runtime.h>

#include "substep_body.cuh"

#define BEZ_E BEZ_ENVS_PER_BLOCK
#define BEZ_THREADS (BEZ_E * BEZ_WARP)

__global__ void __launch_bounds__(BEZ_THREADS)
    bez_substep_kernel(const SubstepTables* __restrict__ tables,
                       const float* __restrict__ state_in,
                       const float* __restrict__ params_in,
                       float* __restrict__ out, int B) {
  extern __shared__ float tiles[];
  const SubstepTables& M = *tables;
  const Layout L = bez_layout(M);
  const int env0 = blockIdx.x * BEZ_E;
  const int n_env = min(BEZ_E, B - env0);  // ragged tail: fewer envs
  bez_stage_in(M, L, BEZ_E, threadIdx.x, env0, n_env, B, state_in,
               params_in, tiles);
  __syncthreads();
  const int w = threadIdx.x / BEZ_WARP;
  if (w < n_env) {
    Lanes lanes;
    lanes.lane = threadIdx.x % BEZ_WARP;
    lanes.reverse = false;
    bez_substep_warp(lanes, M, L, tiles + w * L.size);
  }
  __syncthreads();
  bez_stage_out(M, L, BEZ_E, threadIdx.x, env0, n_env, B, tiles, out);
}

// Dynamic shared memory of one block for the model of `tables_host`; raises
// the kernel's limit on the current device to it (needed above 48 KB).  The
// limit is a per-device attribute, so it is set on every call.  0 on
// success, else the CUDA error.
static int bez_prepare(const SubstepTables& M, size_t* smem) {
  *smem = (size_t)bez_layout(M).size * sizeof(float) * BEZ_E;
  return (int)cudaFuncSetAttribute(bez_substep_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

// Launches one substep over B envs on `stream`.  `tables` is the device
// copy of the tables, `tables_host` the same bytes on the host (the launch
// configuration is computed from it).  Returns 0 on success, else the CUDA
// error of the attribute call or of cudaGetLastError() after the launch;
// the caller raises on anything else.
extern "C" int bez_substep_launch(const void* tables, const void* tables_host,
                                  const float* state_in,
                                  const float* params_in, float* out, int B,
                                  void* stream) {
  if (B <= 0) return 0;
  size_t smem;
  const int rc = bez_prepare(*(const SubstepTables*)tables_host, &smem);
  if (rc != 0) return rc;
  const int blocks = (B + BEZ_E - 1) / BEZ_E;
  bez_substep_kernel<<<blocks, BEZ_THREADS, smem, (cudaStream_t)stream>>>(
      (const SubstepTables*)tables, state_in, params_in, out, B);
  return (int)cudaGetLastError();
}

// The launch configuration for the model of `tables_host`: cfg[0] envs per
// block, cfg[1] threads per block, cfg[2] dynamic shared bytes per block,
// cfg[3] blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int bez_substep_config(const void* tables_host, int* cfg) {
  size_t smem;
  int rc = bez_prepare(*(const SubstepTables*)tables_host, &smem);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bez_substep_kernel, BEZ_THREADS, smem);
  cfg[0] = BEZ_E;
  cfg[1] = BEZ_THREADS;
  cfg[2] = (int)smem;
  cfg[3] = blocks;
  return rc;
}

extern "C" int bez_substep_tables_size() { return (int)sizeof(SubstepTables); }
