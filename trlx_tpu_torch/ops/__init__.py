"""Tensor ops: KV quantization, paged-attention decode, sampling."""
