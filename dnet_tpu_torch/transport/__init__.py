"""Ring transport: the msgpack wire protocol over gRPC generic methods."""
