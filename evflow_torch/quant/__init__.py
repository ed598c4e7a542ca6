"""Quantization of the port: fake quant, PTQ calibration and quantized checkpoints."""
