from .sparse_tensor import SparseConvTensor, BIG_KEY  # noqa: F401
from .modules import (SubMConv3d, SparseConv3d, SubMConv2d,  # noqa: F401
                      SparseConv2d, SparseInverseConv3d, SparseBatchNorm)
