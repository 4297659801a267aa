"""stan4bart_torch — the PyTorch/CUDA port of stan4bart_tpu.

The same model class as the JAX package: a BART sum-of-trees sweep
Gibbs-alternated with NUTS over the rstanarm multilevel log-posterior,

    continuous:  y_i | b ~ N( f(X^b_i) + X^f_i beta + Z_i b, sigma^2 )
    binary:      P(y_i = 1 | b) = Phi( f(X^b_i) + X^f_i beta + Z_i b )

with every chain of a fit advanced as one batch on one device; the
parametric block by NUTS or, with ``algorithm="vi"`` / ``"advi"``, by
VI-within-Gibbs.  The BART
sweep runs as a hand-written CUDA kernel on the GPU (``csrc/*.cu``) and
as its plain PyTorch version on the CPU.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from stan4bart_torch.fit import chi, stan4bart  # noqa: F401
from stan4bart_torch.loo import loo_compare  # noqa: F401
from stan4bart_torch.models import priors  # noqa: F401
from stan4bart_torch.models.priors import (  # noqa: F401
    R2,
    cauchy,
    decov,
    dirichlet,
    exponential,
    hs,
    hs_plus,
    laplace,
    lasso,
    lkj,
    normal,
    product_normal,
    student_t,
)
from stan4bart_torch.parallel.diagnostics import ess, split_rhat  # noqa: F401
from stan4bart_torch.results import Stan4bartFit  # noqa: F401
from stan4bart_torch.utils.friedman import generate_friedman_data  # noqa: F401

__version__ = "0.1.0"
