// K3-mb (lm_solve_mb.cuh) for the dev model: its float64 instances at
// nband 1-6 (the float32 ones are lm_solve_mb_dev.cu).
#include "lm_solve_mb.cuh"

NGMIX_LM_SOLVE_MB(ngmix_lm_solve_mb_dev_f64, double, DevModel)
