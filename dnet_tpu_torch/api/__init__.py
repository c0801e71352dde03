"""OpenAI-compatible API node: schemas, decode driver, adapter, HTTP server."""
