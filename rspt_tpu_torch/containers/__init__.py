"""Host containers of the port (the counterpart of rspt_tpu.containers):
typed 1-4D tensors with JSON round-trip and declarative JSON configs."""

from .tensor import Tensor, tensor_f32, tensor_f64, tensor_i32, \
    tensor_ui32, tensor_ui8, tensor_i8, tensor_ui16, tensor_i16, \
    get_dimensions
from .jsoncfg import JsonSerializable, json_property
