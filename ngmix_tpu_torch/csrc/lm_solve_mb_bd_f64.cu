// K3-mb (lm_solve_mb.cuh) for the bd model: its float64 instances at
// nband 1-6 (the float32 ones are lm_solve_mb_bd.cu).
#include "lm_solve_mb.cuh"

NGMIX_LM_SOLVE_MB(ngmix_lm_solve_mb_bd_f64, double, BdModel)
