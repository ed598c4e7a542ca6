"""Tensor ops of the port: surrogate spikes, LIF updates, the fused
conv+LIF kernels and flow upsampling."""
