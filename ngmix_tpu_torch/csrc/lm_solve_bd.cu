// K3 (lm_solve.cuh) for the bd model: its float32 and float64
// instances, one translation unit, so that nvcc builds them in parallel
// with the other models'.
#include "lm_solve.cuh"

NGMIX_LM_SOLVE(ngmix_lm_solve_bd_f32, float, BdModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_bd_f64, double, BdModel)
