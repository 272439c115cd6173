"""Tensor ops of the port: bounds, densities, schedules, quantization, GDN."""
