from jstsp19.utils.native import (  # noqa: F401
    native_available,
    native_fwht,
    native_sparse_conj_mult,
)
from jstsp19.utils.distributions import (  # noqa: F401
    DisDist,
    weibull_grid,
)
