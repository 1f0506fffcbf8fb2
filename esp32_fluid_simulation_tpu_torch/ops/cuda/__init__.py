"""Hand-written CUDA kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version (``*_reference``) for CPU tensors, and counts its launches in an
integer attribute ``launches``.  The kernels build at first use
(``build.load``), never on import."""
