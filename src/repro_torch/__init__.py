"""FalconGEMM in PyTorch with hand-written CUDA kernels for one NVIDIA H100."""
