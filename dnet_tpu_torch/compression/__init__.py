"""Hop codec of the ring: column sparsification and the sparse wire formats.

Counterpart of dnet_tpu/compression/: the synchronous encode
(`compress_tensor`) and its two halves for the overlapped wire pipeline
(`launch_encode`, `DeviceEncode.finalize`).
"""

from dnet_tpu_torch.compression.ops import (
    column_l2_norms,
    column_sparsify,
    gather_columns,
    scatter_columns,
)
from dnet_tpu_torch.compression.wire import (
    DeviceEncode,
    EncodeStaging,
    codec_name,
    compress_tensor,
    decompress_tensor,
    decompress_tensor_device,
    is_compressed_dtype,
    launch_encode,
)

__all__ = [
    "column_l2_norms",
    "column_sparsify",
    "gather_columns",
    "scatter_columns",
    "DeviceEncode",
    "EncodeStaging",
    "codec_name",
    "compress_tensor",
    "decompress_tensor",
    "decompress_tensor_device",
    "is_compressed_dtype",
    "launch_encode",
]
