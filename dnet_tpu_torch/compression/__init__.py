"""Hop codec of the ring: column sparsification and the sparse wire formats.

Counterpart of dnet_tpu/compression/ (the synchronous encode; the
overlapped wire pipeline's `launch_encode`/`DeviceEncode` is not ported).
"""

from dnet_tpu_torch.compression.ops import (
    column_l2_norms,
    column_sparsify,
    gather_columns,
    scatter_columns,
)
from dnet_tpu_torch.compression.wire import (
    codec_name,
    compress_tensor,
    decompress_tensor,
    decompress_tensor_device,
    is_compressed_dtype,
)

__all__ = [
    "column_l2_norms",
    "column_sparsify",
    "gather_columns",
    "scatter_columns",
    "codec_name",
    "compress_tensor",
    "decompress_tensor",
    "decompress_tensor_device",
    "is_compressed_dtype",
]
