// A measurement probe for chip_smoke.py, not part of the kernel library:
// one cooperative launch of ``n`` grid barriers and nothing else, at the
// grid that st_whole_gru_decode takes for the same widths.  Its time over n
// is what one grid.sync() costs inside the whole-decode kernel.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -shared -I . grid_barrier_probe.cu -o libgrid_barrier_probe.so
//
// The whole-decode source is included so that the occupancy query sees that
// kernel's own registers and shared memory.

#include "show_tell_tpu_torch/csrc/whole_decode.cu"

namespace {

__global__ void __launch_bounds__(kThreads) grid_barriers_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

template <typename T>
cudaError_t launch_barriers(int L, int B, int E, int H, int n, cudaStream_t stream) {
  Params p{};
  p.even.L = L;
  p.even.B = B;
  p.even.I0 = E;
  p.even.H = H;
  const size_t smem = smem_bytes<T>(p);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(whole_gru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, whole_gru_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* argv[] = {&n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_barriers_kernel), dim3(per_sm * sms), dim3(kThreads),
                                    argv, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the whole-decode instance whose grid is
// taken).  Returns a cudaError_t (0 on success).
extern "C" int st_grid_barriers(int dtype, int L, int B, int E, int H, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_barriers<float>(L, B, E, H, n, s));
  if (dtype == 1) return static_cast<int>(launch_barriers<__nv_bfloat16>(L, B, E, H, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
