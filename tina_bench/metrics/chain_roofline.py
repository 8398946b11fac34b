"""chain_roofline (%): the |.|^2 chain's counted bound (complex64 z in,
float32 power out, once) over the device time of ``csrc/elementwise.cu``'s
chain kernel."""
from harness import roofline

PATTERNS = [r"chain_kernel<"]


def read(w):
    return roofline.share(w, "chain", PATTERNS, "chain_roofline")
