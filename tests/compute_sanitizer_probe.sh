#!/bin/bash
# Whether compute-sanitizer can run on this machine's card at all, apart
# from the port: a plain CUDA program (no PyTorch) under memcheck and
# racecheck, the CUDA debugger's view of the same program, and the driver
# and card settings that decide whether the debugger interface is exposed.
# Needs nvcc and a card; prints its findings on stdout.
#
#     bash tests/compute_sanitizer_probe.sh
cuda=${CUDA_HOME:-${CUDA_PATH:-/usr/local/cuda}}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
echo "== kernel"; uname -r
echo "== driver"; cat /proc/driver/nvidia/version 2>&1 | head -2
echo "== driver parameters (profiling, debugging)"
grep -iE "Profil|Debug" /proc/driver/nvidia/params 2>&1
echo "== device files"; ls /dev/ | grep -i nvidia
echo "== card settings"
nvidia-smi -q 2>&1 | grep -iE "Product Name|Driver Version|CUDA Version|Virtualization|vGPU|Confidential|CC |MIG Mode|Addressing Mode|Compute Mode" | head -30
echo "== tools"; ls "$cuda/bin" | grep -iE "sanitizer|gdb"
"$cuda/bin/compute-sanitizer" --version 2>&1 | tail -2
cat > "$work/add.cu" <<'CU'
#include <cstdio>
__global__ void add(const float* a, float* b, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) b[i] += a[i];
}
int main() {
  int n = 1 << 16;
  float *a, *b;
  cudaError_t e = cudaMalloc(&a, n * 4);
  printf("cudaMalloc: %s\n", cudaGetErrorString(e));
  cudaMalloc(&b, n * 4);
  cudaMemset(a, 0, n * 4);
  cudaMemset(b, 0, n * 4);
  add<<<(n + 255) / 256, 256>>>(a, b, n);
  e = cudaDeviceSynchronize();
  printf("kernel: %s\n", cudaGetErrorString(e));
  return e != cudaSuccess;
}
CU
"$cuda/bin/nvcc" -arch=sm_90a -g -o "$work/add" "$work/add.cu" 2>&1 | tail -3
echo "== the program alone"; "$work/add"; echo "rc=$?"
for tool in memcheck racecheck; do
  echo "== compute-sanitizer --tool $tool"
  timeout 120 "$cuda/bin/compute-sanitizer" --tool "$tool" "$work/add" 2>&1 | head -12
  echo "rc=${PIPESTATUS[0]}"
done
echo "== cuda-gdb"
if [ -x "$cuda/bin/cuda-gdb" ]; then
  timeout 120 "$cuda/bin/cuda-gdb" -batch -ex run "$work/add" 2>&1 | tail -15
  echo "rc=${PIPESTATUS[0]}"
else
  echo "the toolkit has no cuda-gdb"
fi
