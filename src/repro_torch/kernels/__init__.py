"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their plain
torch versions, and the wrappers :mod:`repro_torch.core` dispatches to
for ``lowering="kernel"``.  Nothing is built at import: the kernels
compile with ``nvcc`` at first launch (see :mod:`._build`)."""
