// K3 (lm_solve.cuh) for the simple models, exp, gauss and dev: their
// float32 and float64 instances, one translation unit; the composite
// models' are lm_solve_bdf.cu and lm_solve_bd.cu.
#include "lm_solve.cuh"

NGMIX_LM_SOLVE(ngmix_lm_solve_exp_f32, float, ExpModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_exp_f64, double, ExpModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_gauss_f32, float, GaussModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_gauss_f64, double, GaussModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_dev_f32, float, DevModel)
NGMIX_LM_SOLVE(ngmix_lm_solve_dev_f64, double, DevModel)
