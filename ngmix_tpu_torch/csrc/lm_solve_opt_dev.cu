// K3's options kernel (lm_solve_opt.cuh: the refine and varpro modes)
// for the dev model: its float32 and float64 instances, one translation
// unit, so that nvcc builds them in parallel with the other models'.
#include "lm_solve_opt.cuh"

NGMIX_LM_SOLVE_OPT(ngmix_lm_solve_opt_dev_f32, float, DevModel)
NGMIX_LM_SOLVE_OPT(ngmix_lm_solve_opt_dev_f64, double, DevModel)
