// K3-mb (lm_solve_mb.cuh) for the dev model: its float32 instances at
// nband 1-6, one translation unit; the float64 ones, whose spills make
// them the slower to build, are lm_solve_mb_dev_f64.cu, so that nvcc
// builds each model's two halves in parallel with the other units.
#include "lm_solve_mb.cuh"

NGMIX_LM_SOLVE_MB(ngmix_lm_solve_mb_dev_f32, float, DevModel)
