"""Paged-KV cache layer: block accounting and cluster-scale KV movement."""
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.kvcache.transfer import TransferEngine, TransferHandle

__all__ = ["BlockAllocator", "TransferEngine", "TransferHandle"]
