from .sparse_tensor import SparseConvTensor, BIG_KEY  # noqa: F401
from .modules import SubMConv3d, SparseConv3d, SparseBatchNorm  # noqa: F401
