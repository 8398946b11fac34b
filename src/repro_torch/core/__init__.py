"""TINA core in torch: the building blocks, the op mappings, the PFB
itself, int8 quantization, the OpDef layer, the Table-1 registry and the
pipeline registry."""
from repro_torch.core import blocks, functions, pfb, quantize
from repro_torch.core.blocks import (depthwise_conv, fully_connected,
                                     pointwise_conv, standard_conv,
                                     transposed_conv)
from repro_torch.core.functions import (depthwise_fir, dft, elementwise_add,
                                        elementwise_mult, fir, idft, matmul,
                                        overlap_add, summation, unfold)
from repro_torch.core.pfb import pfb as pfb_full
from repro_torch.core.pfb import pfb_frontend, pfb_window

__all__ = [
    "blocks", "functions", "pfb",
    "standard_conv", "depthwise_conv", "pointwise_conv", "transposed_conv",
    "fully_connected", "elementwise_mult", "elementwise_add", "matmul",
    "summation", "dft", "idft", "fir", "depthwise_fir", "unfold",
    "overlap_add", "pfb_full", "pfb_frontend", "pfb_window", "quantize",
]
