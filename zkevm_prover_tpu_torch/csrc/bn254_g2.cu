// The G2 library of the BN254 kernels (`cuda_build.KERNELS["bn254_g2"]`):
// csrc/bn254.cu's MSM and fixed-base kernels over Fp2, compiled apart from
// the G1 and Fr library so that the two nvcc runs overlap.
#define BN254_G2 1
#include "bn254.cu"
