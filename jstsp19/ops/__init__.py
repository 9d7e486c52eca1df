from jstsp19.ops.base import (  # noqa: F401
    LinOp,
    MatrixOp,
    ScaledOp,
    ComposedOp,
    ConcatOp,
    BlockDiagOp,
)
from jstsp19.ops.kron import KronDictOp  # noqa: F401
from jstsp19.ops.masked import MaskOp, DiagOp  # noqa: F401
from jstsp19.ops.fourier import (  # noqa: F401
    DFTOp,
    FWHTOp,
    fwht,
    ToeplitzOp,
    DCTOp,
    dct,
    idct,
)
from jstsp19.ops.structured import (  # noqa: F401
    IdentityOp,
    SubsetOp,
    CenterOp,
    TVOp,
    HaarOp,
    MedImageOp,
    random_unitary_op,
    expander_graph_op,
    rbf_kernel_op,
    sparse_signed_op,
    genie_normal_matvec,
)
