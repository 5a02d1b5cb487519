// K3-mb (lm_solve_mb.cuh) for the exp model: its float32 and float64
// instances at nband 1-6, one translation unit, so that nvcc builds each
// model's instances in parallel with the others'.
#include "lm_solve_mb.cuh"

NGMIX_LM_SOLVE_MB(exp, ExpModel)
