"""Streaming receive: chunked streams and the receive service on one device."""
