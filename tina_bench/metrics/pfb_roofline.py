"""pfb_roofline (%): the ``pfb`` op's counted bound (``counts``: FIR at
the fp32 pipe, the real input's DFT at TF32, x in and complex z out once)
over the device time of its two kernels: ``csrc/pfb.cu``'s f32 frontend
and ``csrc/dft.cu``'s 3xTF32 DFT stage."""
from harness import roofline

PATTERNS = [r"frontend_kernel<(true|false), (true|false)>",
            r"dft_tf32_kernel<"]


def read(w):
    return roofline.share(w, "pfb", PATTERNS, "pfb_roofline")
