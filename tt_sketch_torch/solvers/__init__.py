"""TT-SVD, sketched TT-GMRES and the cookie problem (counterpart of
``tt_sketch_tpu/solvers``)."""
from tt_sketch_torch.solvers.parametric import (  # noqa: F401
    CookieMap,
    prepare_cookie_problem,
    prepare_synthetic_cookie_problem,
)
from tt_sketch_torch.solvers.tt_gmres import (  # noqa: F401
    MPO,
    TTLinearMap,
    TTLinearMapSum,
    TTPrecond,
    round_tt_sum,
    tt_sum_gmres,
)
from tt_sketch_torch.solvers.tt_svd import tt_svd  # noqa: F401
