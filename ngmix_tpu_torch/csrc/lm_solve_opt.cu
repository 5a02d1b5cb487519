// K3's options kernel (lm_solve_opt.cuh: the refine and varpro modes)
// for the exp model: its float32 and float64 instances, one translation
// unit; each other model's are lm_solve_opt_<model>.cu, so that nvcc
// builds them in parallel.
#include "lm_solve_opt.cuh"

NGMIX_LM_SOLVE_OPT(ngmix_lm_solve_opt_exp_f32, float, ExpModel)
NGMIX_LM_SOLVE_OPT(ngmix_lm_solve_opt_exp_f64, double, ExpModel)
