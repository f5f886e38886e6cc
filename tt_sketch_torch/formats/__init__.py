from tt_sketch_torch.formats.base import Tensor  # noqa: F401
from tt_sketch_torch.formats.cp import CPTensor  # noqa: F401
from tt_sketch_torch.formats.dense import DenseTensor  # noqa: F401
from tt_sketch_torch.formats.sparse import SparseTensor  # noqa: F401
from tt_sketch_torch.formats.tensor_sum import TensorSum  # noqa: F401
from tt_sketch_torch.formats.tensor_train import TensorTrain  # noqa: F401
from tt_sketch_torch.formats.tucker import TuckerTensor  # noqa: F401
