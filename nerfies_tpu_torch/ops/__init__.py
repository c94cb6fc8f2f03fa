"""Batched tensor ops of the port: encodings, rigid motion, rendering, MLP kernels."""
