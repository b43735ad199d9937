"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper runs the plain version for a CPU tensor and launches its kernel for
a CUDA tensor (or raises); ``_build.launch_counts`` counts the launches.
"""
