// K3 (lm_solve.cuh) for the bdf model: its float32 and float64
// instances, one translation unit, so that nvcc builds them in parallel
// with the other models'.
#include "lm_solve.cuh"

NGMIX_LM_SOLVE(ngmix_lm_solve_bdf_f32, float, BdfModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_bdf_f64, double, BdfModel)
