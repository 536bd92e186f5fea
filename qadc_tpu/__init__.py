"""qadc-tpu: quantized ANN search on GPUs (Quick ADC capabilities, rebuilt for JAX/XLA/Pallas).

Reference behavior: technicolor-research/quick-adc (see SURVEY.md / ARCHITECTURE.md).
"""

from qadc_tpu.version import __version__

from qadc_tpu.quantizers.pq import ProductQuantizer, train_pq, encode, decode
from qadc_tpu.quantizers.opq import OPQQuantizer, train_opq
from qadc_tpu.index.flat import FlatIndex
from qadc_tpu.index.ivf import IVFIndex

__all__ = [
    "__version__",
    "ProductQuantizer",
    "OPQQuantizer",
    "train_pq",
    "train_opq",
    "encode",
    "decode",
    "FlatIndex",
    "IVFIndex",
]
