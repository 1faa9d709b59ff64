"""Bitmap math: host/device bit operations and the CUDA count kernels."""
