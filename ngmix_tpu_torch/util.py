"""Device selection and ratio-error propagation.

``get_ratio_var`` / ``get_ratio_error`` are the port's copies of
``ngmix_tpu/util.py:34-54``; they never raise on b == 0 (the variance
is +inf there).
"""
import torch


def resolve_device(device=None):
    """the torch.device an entry point runs on.

    None means the CUDA card; a missing card raises rather than moving
    the work to the CPU. Pass device="cpu" to run the plain versions
    of the kernels on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def full_precision_matmuls():
    """keep float32 matrix products and convolutions in full float32
    (no TF32), the counterpart of the JAX package's
    Precision.HIGHEST: lower precision biased m to -1.4e-2"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_ratio_var(a, b, var_a, var_b, cov_ab):
    """variance of (a/b); safe for b == 0 (returns +inf)."""
    bsafe = torch.where(b == 0, 1.0, b)
    asafe = torch.where(a == 0, 1.0, a)
    rsq = (a / bsafe) ** 2
    var = rsq * (
        var_a / asafe**2 + var_b / bsafe**2 - 2 * cov_ab / (asafe * bsafe)
    )
    # a == 0 limit: var((a/b)) -> var_a / b^2
    var = torch.where(a == 0, var_a / bsafe**2, var)
    return torch.where(b == 0, torch.inf, var)


def get_ratio_error(a, b, var_a, var_b, cov_ab):
    """error on a/b, clipped at 0"""
    var = get_ratio_var(a, b, var_a, var_b, cov_ab)
    return torch.sqrt(torch.clamp(var, 0.0, torch.inf))
