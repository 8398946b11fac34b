"""setup_s (s): from the process's start to the window's first call:
imports, the kernel library from the checkout's build cache, the taps
and the inputs made on the card, the plans compiled and warmed."""


def read(w):
    return w.setup_s
