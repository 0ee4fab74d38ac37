"""Streaming receive: chunked streams and the receive service over a device mesh."""
