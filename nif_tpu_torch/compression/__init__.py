"""Compression (counterpart of ``nif_tpu/compression``): magnitude pruning,
int8 post-training quantization, and NIF-linear's int8 ROM decode."""
from .pruning import MagnitudePruning, apply_mask, prune_by_magnitude, sparsity
from .quantization import (dequantize_params, quantize_params, quantize_shared_mesh,
                           quantized_size_bytes, rom_decode_int8)

__all__ = [
    "prune_by_magnitude",
    "apply_mask",
    "sparsity",
    "MagnitudePruning",
    "quantize_params",
    "dequantize_params",
    "quantized_size_bytes",
    "quantize_shared_mesh",
    "rom_decode_int8",
]
