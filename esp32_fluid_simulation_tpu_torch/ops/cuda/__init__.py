"""Hand-written CUDA kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version (``*_reference``) for CPU tensors, and counts its launches in an
integer attribute ``launches``.  Every launch goes through
``build.launch``; the kernels build at its first call (``build.load``),
never on import."""
