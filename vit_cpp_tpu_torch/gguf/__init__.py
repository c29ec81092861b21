from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType  # noqa: F401
from vit_cpp_tpu_torch.gguf.reader import ModelFile, TensorRecord, read_model  # noqa: F401
from vit_cpp_tpu_torch.gguf.writer import write_model  # noqa: F401
